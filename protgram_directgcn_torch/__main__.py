"""Pipeline CLI of the port: ``python -m protgram_directgcn_torch``.

    python -m protgram_directgcn_torch --fasta seqs.fasta --out results \\
        --stages graph,gcn [--set gcn.epochs_per_level=5 ...] [--device cpu]

Runs the stages this slice has (graph building, hierarchical GCN training and
protein pooling) on the card, or on the CPU with ``--device cpu``.  The other
stages of the JAX package's ``main.py`` (word2vec, transformer, benchmark,
ppi) are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from protgram_directgcn_torch.config import Config

_PORTED = {"graph", "gcn"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ProtGram-DirectGCN pipeline (PyTorch/CUDA)")
    p.add_argument("--config", help="JSON config overrides file")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="dotted config override, e.g. --set gcn.lr=0.001")
    p.add_argument("--fasta", help="input FASTA path")
    p.add_argument("--out", help="base output directory")
    p.add_argument("--stages", default="graph,gcn", help="comma list of graph,gcn")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def _parse_value(raw: str):
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def build_config(args) -> Config:
    cfg = Config.from_json(args.config) if args.config else Config()
    for item in args.set:
        key, _, value = item.partition("=")
        cfg.apply_overrides({key: _parse_value(value)})
    if args.fasta:
        cfg.paths.input_fasta = Path(args.fasta)
    if args.out:
        cfg.paths.base_output_dir = Path(args.out)
    return cfg


def main(argv=None):
    """Run the requested stages; returns ``{"graphs": [...], "graph_etl":
    {n: the builder's stats of level n, with the ETL path it took},
    "trainer": ..., "pooled": {protein_id: vector}, "embeddings_path": the
    last embeddings file written, "seconds": {"graph": s, "gcn": s}}``
    (trainer, pooled and the path are None, and "gcn" absent, when only the
    graph stage ran)."""
    args = parse_args(argv)
    wanted = {s.strip() for s in args.stages.split(",") if s.strip()}
    if wanted - _PORTED:
        raise NotImplementedError(
            f"stages {sorted(wanted - _PORTED)} are not ported yet (ROADMAP Queue 1)"
        )
    cfg = build_config(args)
    from protgram_directgcn_torch.graph.builder import NgramGraphBuilder
    from protgram_directgcn_torch.pipeline.trainer import HierarchicalTrainer
    from protgram_directgcn_torch.utils.io import logger

    if cfg.debug_verbose:
        import logging

        logger.setLevel(logging.DEBUG)
    trainer = None
    if "gcn" in wanted:  # fail before the ETL when the device is absent
        trainer = HierarchicalTrainer(cfg, device=args.device)
    t0 = time.monotonic()
    builder = NgramGraphBuilder(cfg)
    result = {"graphs": builder.run(), "graph_etl": builder.stats, "trainer": trainer,
              "pooled": None, "embeddings_path": None,
              "seconds": {"graph": time.monotonic() - t0}}
    if trainer is not None:
        t_gcn = time.monotonic()
        result["embeddings_path"] = trainer.run()
        result["pooled"] = trainer.pooled
        result["seconds"]["gcn"] = time.monotonic() - t_gcn
    logger.info("pipeline finished in %.1fs", time.monotonic() - t0)
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
