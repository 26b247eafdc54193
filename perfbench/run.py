"""One run of one cell of the PyTorch port's benchmark.

    python3 perfbench/run.py --workload hyper.ngram4 --seed 12345 --seconds 10 --trace 0

Prints the result as one JSON object on the last line of standard output,
and the numbers that decided ``correct``, each beside its limit, as the last
lines of standard error.  Exits non-zero, printing no result, where the
cell's CUDA devices are missing, and where a module of the JAX package (or
JAX itself) was loaded.  Run from the root of a checkout; see README.md.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

# The checkout's root, not this folder, heads the import path.
sys.path[0] = str(Path(__file__).resolve().parents[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from perfbench.lib import runner

    return runner.main(args.workload, args.seed, args.seconds, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
