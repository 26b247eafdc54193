"""Pipeline CLI of the port: ``python -m protgram_directgcn_torch``.

    python -m protgram_directgcn_torch --fasta seqs.fasta --out results \\
        --stages graph,gcn,word2vec,benchmark,ppi [--set gcn.epochs_per_level=5 ...] \\
        [--device cpu]

Runs the ported stages in the JAX package's ``main.py`` order: graph
building (with ``graph`` or ``gcn``), hierarchical GCN training, protein
pooling and the PPI sanity check (``gcn``), the Word2Vec baseline
(``word2vec``), the GNN zoo benchmark on node classification
(``benchmark``), and PPI link-prediction evaluation of the embedding sets
found under ``--out`` (``ppi``; ``dummy`` evaluates synthetic data
instead), on the card, or on the CPU with ``--device cpu``.  The
``transformer`` stage is not ported yet and raises.

Node-sharded training, one process a device (main.py:78-80):

    torchrun --nproc-per-node D -m protgram_directgcn_torch --stages graph,gcn \
        --set parallel.mesh_nodes=D [--set parallel.mode=hypercube]

starts the process group first (``parallel.distributed``); rank 0 builds the
graphs while the others wait at a barrier, every rank trains every level
over its node shard, and rank 0 alone writes the embeddings and runs the
word2vec, benchmark, ppi and dummy stages.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from protgram_directgcn_torch.config import Config

_PORTED = {"graph", "gcn", "word2vec", "benchmark", "ppi", "dummy"}
_UNPORTED = {"transformer": "Queue 1 item 14 (the transformer stage)"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ProtGram-DirectGCN pipeline (PyTorch/CUDA)")
    p.add_argument("--config", help="JSON config overrides file")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="dotted config override, e.g. --set gcn.lr=0.001")
    p.add_argument("--fasta", help="input FASTA path")
    p.add_argument("--out", help="base output directory")
    p.add_argument("--stages", default="graph,gcn",
                   help="comma list of graph,gcn,word2vec,benchmark,ppi,dummy")
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
    GCN stage's last embeddings file, "embedder": the Word2VecEmbedder,
    "word2vec_path": its pooled embeddings file, "benchmarker": the
    GNNBenchmarker, "benchmark_results": its result rows, "ppi": the
    PPIPipeline, "ppi_results": its results, "seconds": {stage: s}}`` (a
    stage that did not run leaves its entries None and its seconds
    absent)."""
    args = parse_args(argv)
    wanted = {s.strip() for s in args.stages.split(",") if s.strip()}
    unported = sorted(wanted & set(_UNPORTED))
    if unported:
        raise NotImplementedError(f"stages {unported} are not ported yet (ROADMAP "
                                  + "; ".join(_UNPORTED[s] for s in unported) + ")")
    if wanted - _PORTED:
        raise ValueError(f"unknown stages {sorted(wanted - _PORTED)}")
    cfg = build_config(args)
    from protgram_directgcn_torch.parallel import distributed as comm

    comm.initialize_distributed(device="cpu" if args.device == "cpu" else "cuda")
    if comm.world_size() > 1 and cfg.parallel.mesh_nodes is None:
        raise ValueError(f"{comm.world_size()} processes but parallel.mesh_nodes is unset: "
                         f"pass --set parallel.mesh_nodes={comm.world_size()}")
    if cfg.parallel.mesh_nodes is not None:
        cfg.parallel.check()
    main_rank = comm.is_main()
    st = cfg.stages
    st.run_gcn_pipeline = bool(wanted & {"graph", "gcn"})
    st.run_word2vec_pipeline = "word2vec" in wanted
    st.run_benchmarking_pipeline = "benchmark" in wanted
    st.run_main_ppi_evaluation = "ppi" in wanted
    st.run_dummy_test = "dummy" in wanted
    from protgram_directgcn_torch.bench.gnn_benchmarker import GNNBenchmarker
    from protgram_directgcn_torch.graph.builder import NgramGraphBuilder
    from protgram_directgcn_torch.pipeline.ppi import PPIPipeline
    from protgram_directgcn_torch.pipeline.trainer import HierarchicalTrainer
    from protgram_directgcn_torch.pipeline.word2vec import Word2VecEmbedder
    from protgram_directgcn_torch.utils.io import logger

    if cfg.debug_verbose:
        import logging

        logger.setLevel(logging.DEBUG)
    # Every device stage resolves its device first: fail before any work
    # when the card is absent.
    trainer = HierarchicalTrainer(cfg, device=args.device) if "gcn" in wanted else None
    embedder = (Word2VecEmbedder(cfg, device=args.device)
                if st.run_word2vec_pipeline and main_rank else None)
    benchmarker = (GNNBenchmarker(cfg, device=args.device)
                   if st.run_benchmarking_pipeline and main_rank else None)
    ppi = (PPIPipeline(cfg, device=args.device)
           if (st.run_main_ppi_evaluation or st.run_dummy_test) and main_rank else None)
    t0 = time.monotonic()
    result = {"graphs": None, "graph_etl": None, "trainer": trainer, "pooled": None,
              "embeddings_path": None, "embedder": embedder, "word2vec_path": None,
              "benchmarker": benchmarker, "benchmark_results": None,
              "ppi": ppi, "ppi_results": None, "seconds": {}}
    if st.run_gcn_pipeline:
        if main_rank:
            builder = NgramGraphBuilder(cfg)
            result["graphs"] = builder.run()
            result["graph_etl"] = builder.stats
        comm.barrier()
        result["seconds"]["graph"] = time.monotonic() - t0
    if trainer is not None:
        t_stage = time.monotonic()
        result["embeddings_path"] = trainer.run()
        result["pooled"] = trainer.pooled
        result["seconds"]["gcn"] = time.monotonic() - t_stage
    if embedder is not None:
        t_stage = time.monotonic()
        result["word2vec_path"] = embedder.run()
        result["seconds"]["word2vec"] = time.monotonic() - t_stage
    if benchmarker is not None:
        t_stage = time.monotonic()
        result["benchmark_results"] = benchmarker.run()
        result["seconds"]["benchmark"] = time.monotonic() - t_stage
    if ppi is not None:
        t_stage = time.monotonic()
        result["ppi_results"] = ppi.run(use_dummy_data=st.run_dummy_test)
        result["seconds"]["ppi"] = time.monotonic() - t_stage
    logger.info("pipeline finished in %.1fs", time.monotonic() - t0)
    return result


if __name__ == "__main__":
    main()
    from protgram_directgcn_torch.parallel import distributed as _comm

    if _comm.is_initialized():
        _comm.barrier()
        _comm.dist.destroy_process_group()
    sys.exit(0)
