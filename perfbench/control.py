"""Readings that set a cell's limits: on each seed, the program's first
steps, and in the program's place the reference computed with TF32 on (the
control: the nearest precision below the configuration's float32) and the
reference whose loss is the mean over half the real nodes (a planted
fault), each compared with the float32 reference by ``check.compare``.  The
reference is the one of the model that the cell's configuration names
(``models/<model>.py``: its ``first_steps`` with ``tf32`` or ``half_batch``).

    python3 perfbench/control.py --workload hyper.ngram4 --seeds 11 12 13 \\
        --out control_hyper.jsonl

Needs the card (TF32 is a CUDA matmul mode).  One JSON line a seed.  The
fourth fault of a training cell, a state left unchanged, reads 1 on
``change_gap`` by that number's definition and needs no run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

import torch  # noqa: E402

from perfbench.lib import check, corpus, manifest, runner  # noqa: E402


def as_program(ref: dict) -> dict:
    """A reference run's readings in the program's place."""
    return {"losses": ref["losses"], "grad_norms": ref["grad_norms"],
            "change_norms": ref["change_norms"], "numels": ref["numels"],
            "steps_at_checked": list(range(1, len(ref["losses"]) + 1))}


def readings(bench: dict, cell: dict, seeds, device, mix=None, cache_root=corpus.CACHE):
    """Yield one dict of numbers a seed: ``sound`` (the program),
    ``control`` and ``half_batch``."""
    cfg = manifest.config(bench, cell["config"])
    model = manifest.model(bench, cell["config"])
    mix = mix or manifest.traffic(cell["traffic"])
    fasta, graph_path = corpus.level_files(mix, cache_root)
    from protgram_directgcn_torch.graph.structure import load_graph

    for seed in seeds:
        t0 = time.perf_counter()
        out = {"seed": seed}
        graph = load_graph(graph_path)
        x, y = corpus.draw_inputs(graph.num_nodes, mix["feat_dim"], mix["num_classes"], seed)
        run = runner.run_program(cfg, graph, x, y, mix["num_classes"], seed, 0.0, False, device)
        runner.check_plan(run.plan, cfg)
        prog = {"losses": run.clock.losses, "grad_norms": run.recorder.grad_norms,
                "change_norms": run.recorder.change_norms, "numels": run.recorder.numels,
                "steps_at_checked": run.clock.steps_at_checked}
        del run, graph
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        level = runner.reference_level(model, cfg, mix, fasta, device)
        ref = model.first_steps(level, cfg, x, y, mix["num_classes"], seed,
                                runner.CHECKED_STEPS, device)
        out["sound"], out["sound_notes"] = check.compare(prog, ref)
        out["losses"] = {"reference": ref["losses"], "program": prog["losses"]}
        for name, kw in (("control", {"tf32": True}), ("half_batch", {"half_batch": True})):
            other = model.first_steps(level, cfg, x, y, mix["num_classes"], seed,
                                      runner.CHECKED_STEPS, device, **kw)
            out[name] = check.compare(as_program(other), ref)[0]
            out["losses"][name] = other["losses"]
        del level
        gc.collect()
        out["seconds"] = time.perf_counter() - t0
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    bench = manifest.benchmark()
    cell = manifest.workload(bench, args.workload)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as fh:
        for line in readings(bench, cell, args.seeds, torch.device("cuda", 0)):
            fh.write(json.dumps(line) + "\n")
            fh.flush()
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
