"""Weak- and fixed-graph scaling of the sharded propagations.

Port of protgram_directgcn_tpu/bench/scaling.py: propagation throughput as
the node shards grow, in the port's one-process-a-device layout.  Run it
under ``torchrun`` with world size max(D):

    torchrun --nproc-per-node 4 -m protgram_directgcn_torch.bench.scaling \\
        [ngram|uniform|hyper|fivegram] [TRACE_DIR] [--device cpu]

(without torchrun: D = 1 alone).  Each D point runs on the ranks [0, D)
(a process group of its own, made on every rank in one order); the other
ranks wait at a barrier.  Rank 0 prints the JSON.

Workloads (the JAX package's):

- ``ngram``: a suffix-structured transition graph, every edge
  ``r*G + g -> g*alpha + c`` (``_ngram_pattern_graph``), through the halo
  exchange, ``nodes_per_shard`` nodes a shard (``weak_scaling_report``);
- ``uniform``: uniform-random targets, the adversarial point;
- ``hyper``: the key-sharded hypercube with dense random banks,
  ``keys_per_shard`` keys a shard (``hyper_shard_scaling_report``);
- ``fivegram``: one fixed 5-gram propagation matrix (built from 30,000
  seeded motif sequences by the port's builder and cached, or any saved
  graph level) through the curves ``halo``, ``tri_halo`` (one exchange, three
  products), ``hyper_shard``, ``hyper_shard_tri`` and ``gspmd``
  (``fivegram_scaling_report``); ``PROTGRAM_HS_NOCOMM=1`` for the run gives
  the hypercube curves without their exchanges (compute alone).

Timing: a carry-dependent chain ``x = f(x)``, warmed once, best of 3, on
the card between CUDA events after a ``torch.cuda.synchronize`` (the JAX
package forces completion with a host fetch), on the CPU on the host clock;
a point's time is its slowest rank's.  Under gloo with two ranks on one
card the exchanges pass through host memory: such a point checks the path
and measures no scaling.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from protgram_directgcn_torch.parallel import distributed as comm
from protgram_directgcn_torch.parallel import gspmd, halo, hyper_shard as hs
from protgram_directgcn_torch.utils.device import resolve_device
from protgram_directgcn_torch.utils.io import logger

_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), ".scaling_graph_5gram_torch.npz")


@dataclass
class ScalingPoint:
    shards: int
    num_nodes: int
    nnz: int
    seconds_per_step: float
    edges_per_s: float
    efficiency: float  # per-shard rate vs the 1-shard point (Nx-hardware view)
    aggregate_retention: float  # total rate vs 1 shard (shared-hardware view)


def _uniform_graph(n: int, deg: int, seed: int):
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    tgt = rng.integers(0, n, n * deg)
    pairs, counts = np.unique(np.stack([src, tgt], 1), axis=0, return_counts=True)
    return pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32), counts.astype(np.float32)


def _ngram_pattern_graph(n: int, deg: int, seed: int, alpha: int = 16):
    """Suffix-structured directed graph on N = alpha*G ids: every source
    ``r*G + g`` links to targets ``g*alpha + c`` (the n-gram A-pattern)."""
    assert n % alpha == 0, (n, alpha)
    g_keys = n // alpha
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    suffix = src % g_keys
    tgt = suffix * alpha + rng.integers(0, alpha, n * deg)
    pairs, counts = np.unique(np.stack([src, tgt], 1), axis=0, return_counts=True)
    return pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32), counts.astype(np.float32)


def build_or_load_graph(num_seqs: int, seed: int = 0, cache: Optional[str] = _CACHE):
    """The 5-gram 𝒜_out of ``num_seqs`` seeded motif sequences, its n-gram
    node keys and character codes: ``(src, tgt, val, n, (pk, sk, nk),
    (codes, alpha))``, the recipe of the repo's root ``bench.py:52-95``
    built by the port's builder, cached at ``cache`` (None: not cached)."""
    if cache is not None and os.path.exists(cache):
        with np.load(cache) as z:
            keys = (z["pk"], z["sk"], int(z["nk"]))
            codes = (z["codes"], int(z["alpha"]))
            return z["src"], z["tgt"], z["val"], int(z["n"]), keys, codes
    from protgram_directgcn_torch.graph.builder import NgramGraphBuilder
    from protgram_directgcn_torch.graph.transforms import csr_to_coo_arrays
    from protgram_directgcn_torch.ops.block import ngram_node_keys
    from protgram_directgcn_torch.ops.hypercube import vocab_char_codes

    rng = np.random.default_rng(seed)
    aa = list("ACDEFGHIKLMNPQRSTVWY")
    motifs = ["".join(rng.choice(aa, 8)) for _ in range(500)]

    def make_seq():
        parts, length = [], 0
        while length < 300:
            m = (motifs[rng.integers(0, len(motifs))] if rng.random() < 0.5
                 else "".join(rng.choice(aa, 8)))
            parts.append(m)
            length += len(m)
        return "".join(parts)

    seqs = [(f"P{i}", make_seq()) for i in range(num_seqs)]
    g5 = NgramGraphBuilder(n_max=5).build_from_sequences(seqs)[4]
    src, tgt, val = csr_to_coo_arrays(g5.mathcal_a_out())
    pk, sk, nk = ngram_node_keys(g5.vocab)
    codes, alpha = vocab_char_codes(g5.vocab)
    if cache is not None:
        np.savez_compressed(cache, src=src, tgt=tgt, val=val, n=np.int64(g5.num_nodes),
                            pk=pk.astype(np.int32), sk=sk.astype(np.int32), nk=np.int64(nk),
                            codes=codes.astype(np.int8), alpha=np.int64(alpha))
    return src, tgt, val, g5.num_nodes, (np.asarray(pk), np.asarray(sk), int(nk)), (codes, alpha)


def _graph_from_file(path: str):
    """A saved graph level's 𝒜_out and character codes, in
    ``build_or_load_graph``'s form (no node keys)."""
    from protgram_directgcn_torch.graph.structure import load_graph
    from protgram_directgcn_torch.graph.transforms import csr_to_coo_arrays
    from protgram_directgcn_torch.ops.hypercube import vocab_char_codes

    g = load_graph(path)
    src, tgt, val = csr_to_coo_arrays(g.mathcal_a_out())
    return src, tgt, val, g.num_nodes, None, vocab_char_codes(g.vocab)


def _shard_counts(shard_counts: Optional[Sequence[int]], choices=(1, 2, 4, 8, 16)) -> List[int]:
    world = comm.world_size()
    counts = [d for d in choices if d <= world] if shard_counts is None else list(shard_counts)
    if max(counts) > world:
        raise ValueError(f"shard counts {counts} need world size {max(counts)}; it is {world}")
    return counts


@contextlib.contextmanager
def _on_ranks(d: int):
    """(whether this rank is a member, the process group of ranks [0, d)),
    the group made on every rank; every rank waits at a barrier after."""
    group = comm.new_group(range(d))
    try:
        yield comm.rank() < d, group
    finally:
        comm.barrier()


def _time_chain(fn: Callable, x0, iters: int, device: torch.device, group) -> float:
    """Seconds a step of ``x = fn(x)``: warmed once, best of 3, the slowest
    rank of ``group``'s."""
    with torch.no_grad():
        fn(x0)
        best = float("inf")
        for _ in range(3):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            out = x0
            for _ in range(iters):
                out = fn(out)
            if device.type == "cuda":
                end.record()
                torch.cuda.synchronize(device)
                seconds = start.elapsed_time(end) / 1e3
            else:
                seconds = time.perf_counter() - t0
            best = min(best, seconds / iters)
    t = torch.tensor([best], dtype=torch.float64)
    if comm.group_size(group) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t[0])


def _point(d, n, nnz, best, base) -> ScalingPoint:
    rate = nnz / best
    base = base if base is not None else (rate / d, rate)
    return ScalingPoint(shards=d, num_nodes=n, nnz=nnz, seconds_per_step=best, edges_per_s=rate,
                        efficiency=(rate / d) / base[0], aggregate_retention=rate / base[1])


def _features(rng, shape, device) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)


def _rows(rng, nd: int, r: int, n: int, feat_dim: int, device) -> torch.Tensor:
    """Rank r's block of ``nd`` rows of seeded features over n nodes, zero
    past node n - 1."""
    x = rng.standard_normal((nd, feat_dim)).astype(np.float32)
    x[max(0, n - r * nd):] = 0
    return torch.from_numpy(x).to(device)


def hyper_shard_scaling_report(keys_per_shard: int = 512, alpha: int = 12, feat_dim: int = 64,
                               shard_counts: Optional[List[int]] = None, iters: int = 10,
                               seed: int = 0, device="cuda") -> List[ScalingPoint]:
    """Weak scaling of the key-sharded hypercube propagation
    (parallel/hyper_shard.py): per shard, ``keys_per_shard`` suffix keys of
    an [alpha x G] hypercube with dense random banks (nodes = alpha * G,
    edges ~ alpha^2 * G)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    points: List[ScalingPoint] = []
    base = None
    for d in _shard_counts(shard_counts):
        g, gd = keys_per_shard * d, keys_per_shard
        n = alpha * g
        wf = rng.standard_normal((d, alpha, gd, alpha)).astype(np.float32) * 0.05
        wb = rng.standard_normal((d, alpha, gd, alpha)).astype(np.float32) * 0.05
        diag = rng.standard_normal((d, alpha, gd)).astype(np.float32) * 0.1
        x = rng.standard_normal((alpha, g, feat_dim)).astype(np.float32)
        nnz = 2 * alpha * alpha * g + n  # both banks dense + diagonal
        with _on_ranks(d) as (member, group):
            if not member:
                continue
            r = comm.rank()
            adj = hs.HyperShardAdj(
                d=torch.from_numpy(diag[r]).to(dev), wf=torch.from_numpy(wf[r]).to(dev),
                wb=torch.from_numpy(wb[r]).to(dev),
                tables=hs.HyperShardTables.for_rank(hs.build_hyper_shard_tables(alpha, g, d), r,
                                                    dev),
                node_map=np.arange(n), num_shards=d, rank=r, group=group)
            xs = torch.from_numpy(np.ascontiguousarray(x[:, r * gd:(r + 1) * gd])).to(dev)
            best = _time_chain(lambda v: hs.propagate(adj, v), xs, iters, dev, group)
        points.append(_point(d, n, nnz, best, base))
        base = base or (points[0].edges_per_s / d, points[0].edges_per_s)
        logger.info("hyper-shard weak scaling D=%d: %d nodes, %d edge-equivs, %.3fms/step, "
                    "%.2fM edges/s, eff=%.2f retention=%.2f", d, n, nnz, best * 1e3,
                    points[-1].edges_per_s / 1e6, points[-1].efficiency,
                    points[-1].aggregate_retention)
    return points


def weak_scaling_report(nodes_per_shard: int = 4096, deg: int = 16, feat_dim: int = 64,
                        shard_counts: Optional[List[int]] = None, iters: int = 10,
                        seed: int = 0, graph: str = "ngram", trace_dir: Optional[str] = None,
                        device="cuda") -> List[ScalingPoint]:
    """Weak scaling of the halo-exchange product, ``nodes_per_shard`` nodes
    a shard of the ``graph`` workload; ``trace_dir``: a profiler trace of
    the largest point's chain (rank 0's)."""
    from protgram_directgcn_torch.utils.profiling import capture_trace

    dev = resolve_device(device)
    counts = _shard_counts(shard_counts)
    make_graph = {"ngram": _ngram_pattern_graph, "uniform": _uniform_graph}[graph]
    points: List[ScalingPoint] = []
    base = None
    for d in counts:
        n = nodes_per_shard * d
        src, tgt, w = make_graph(n, deg, seed)
        tables = halo.build_halo_tables(src, tgt, w, n, d)
        x_np = np.random.default_rng(seed).standard_normal((n, feat_dim)).astype(np.float32)
        with _on_ranks(d) as (member, group):
            if not member:
                continue
            part = halo.HaloPartition.from_tables(tables, comm.rank(), dev, group=group)
            x = torch.from_numpy(halo.pad_node_features(x_np, part)[
                part.rank * part.rows_per_shard:(part.rank + 1) * part.rows_per_shard]).to(dev)

            def fn(v):
                return halo.halo_propagate(part, v)

            best = _time_chain(fn, x, iters, dev, group)
            if trace_dir is not None and d == counts[-1]:
                with (capture_trace(trace_dir, dev) if comm.rank() == 0
                      else contextlib.nullcontext()), torch.no_grad():
                    out = x
                    for _ in range(iters):
                        out = fn(out)
        points.append(_point(d, n, len(src), best, base))
        base = base or (points[0].edges_per_s / d, points[0].edges_per_s)
        logger.info("weak scaling [%s] D=%d: %d nodes, %d edges, %.3fms/step, %.2fM edges/s, "
                    "eff=%.2f retention=%.2f", graph, d, n, len(src), best * 1e3,
                    points[-1].edges_per_s / 1e6, points[-1].efficiency,
                    points[-1].aggregate_retention)
    return points


_CURVES = ("halo", "tri_halo", "hyper_shard", "hyper_shard_tri", "gspmd")


def fivegram_scaling_report(feat_dim: int = 32, shard_counts: Optional[List[int]] = None,
                            iters: int = 2, num_seqs: int = 30_000,
                            curves: Optional[List[str]] = None, graph_path: Optional[str] = None,
                            device="cuda", cache: Optional[str] = _CACHE) -> dict:
    """Scaling curves on one fixed graph: the 5-gram 𝒜_out of
    ``build_or_load_graph(num_seqs)``, or the 𝒜_out of the graph level saved
    at ``graph_path``, f32.  ``halo``: the ring halo-exchange product;
    ``tri_halo``: one shared exchange feeding three products;
    ``hyper_shard`` / ``hyper_shard_tri``: the key-sharded hypercube with the
    real banks, one matrix or three on one exchange; ``gspmd``: the
    row-sharded ELL over gathered features.  The graph is fixed while the
    shards grow, so the ideal on shared hardware is a constant aggregate
    rate (``aggregate_retention``).  Returns ``{"graph": {...}, curve:
    [point dicts]}``; a curve's edges a step are 3 x nnz where three
    products run."""
    dev = resolve_device(device)
    if graph_path is not None:
        src, tgt, val, n, _, (codes, alpha) = _graph_from_file(graph_path)
    else:
        src, tgt, val, n, _, (codes, alpha) = build_or_load_graph(num_seqs, cache=cache)
    val = (val / max(1e-9, float(np.abs(val).max()))).astype(np.float32)
    nnz = len(src)
    codes = np.asarray(codes, np.int64)
    a = int(alpha)
    g_keys = a ** (codes.shape[1] - 1)
    logger.info("scaling graph: n=%d nnz=%d alpha=%d", n, nnz, a)
    counts = _shard_counts(shard_counts, (1, 2, 4, 8))
    wanted = [c for c in _CURVES if c in set(curves if curves is not None else _CURVES)]
    results: dict = {"graph": {"nodes": int(n), "nnz": int(nnz), "alpha": a}}
    for curve in wanted:
        three = curve in ("tri_halo", "hyper_shard_tri")
        edges = (3 if three else 1) * nnz
        rates = []
        for d in counts:
            with _on_ranks(d) as (member, group):
                if not member:
                    continue
                fn, x = _curve_operator(curve, src, tgt, val, n, codes, a, g_keys, d, group,
                                        feat_dim, dev)
                best = _time_chain(fn, x, iters, dev, group)
            rates.append((d, edges / best))
            logger.info("[scaling %s] D=%d: %.1f ms/step, %.1fM edges/s", curve, d, best * 1e3,
                        rates[-1][1] / 1e6)
            del fn, x
        if not rates:  # a rank outside every point's group
            continue
        base = rates[0][1]
        results[curve] = [ScalingPoint(shards=d, num_nodes=int(n), nnz=edges,
                                       seconds_per_step=edges / r, edges_per_s=r,
                                       efficiency=(r / d) / base,
                                       aggregate_retention=r / base).__dict__
                          for d, r in rates]
    return results


def _curve_operator(curve, src, tgt, val, n, codes, a, g_keys, d, group, feat_dim, dev):
    """(step function, this rank's input: its rows of seeded features, zero
    on padding rows) of one curve at d shards."""
    r = comm.rank()
    rng = np.random.default_rng([_CURVES.index(curve), d, r])
    if curve in ("hyper_shard", "hyper_shard_tri"):
        tables = hs.build_hyper_shard_tables(a, g_keys, d)
        adj = hs.build_hyper_shard(src, tgt, val, codes, a, d, r, dev, torch.float32, tables,
                                   group)
        xs = [_features(rng, adj.feature_shape + (feat_dim,), dev)
              for _ in range(3 if curve == "hyper_shard_tri" else 1)]
        if curve == "hyper_shard":
            return (lambda v: hs.propagate(adj, v)), xs[0]
        tri = hs.HyperShardTri(adjs=(adj, adj, adj))
        return (lambda v: hs.propagate_tri(tri, *v)), tuple(xs)
    if curve == "gspmd":
        adj = gspmd.RowShardEllAdj.from_tables(gspmd.build_row_shard_tables(src, tgt, val, n, d),
                                               d, r, dev, group)
        return (lambda v: gspmd.propagate(adj, v)), _rows(rng, adj.n_out, r, n, feat_dim, dev)
    if curve == "halo":
        part = halo.HaloPartition.from_tables(halo.build_halo_tables(src, tgt, val, n, d), r, dev,
                                              group=group)
        parts = [part]
    else:
        parts = [halo.HaloPartition.from_tables(t, r, dev, group=group)
                 for t in halo.build_tri_halo_tables([(src, tgt, val)] * 3, n, d)]
    xs = [_rows(rng, parts[0].rows_per_shard, r, n, feat_dim, dev) for _ in parts]
    if curve == "halo":
        return (lambda v: halo.halo_propagate(parts[0], v)), xs[0]
    tri = halo.TriHaloPartition(parts=tuple(parts))
    return (lambda v: halo.tri_halo_propagate(tri, v)), tuple(xs)


def main(argv=None) -> None:
    import argparse
    import json

    p = argparse.ArgumentParser(description="Scaling of the sharded propagations")
    p.add_argument("graph", nargs="?", default="ngram",
                   choices=["ngram", "uniform", "hyper", "fivegram"])
    p.add_argument("trace_dir", nargs="?", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    comm.initialize_distributed(device=args.device)
    if args.graph == "fivegram":
        out = fivegram_scaling_report(device=args.device)
    elif args.graph == "hyper":
        out = [pt.__dict__ for pt in hyper_shard_scaling_report(device=args.device)]
    else:
        out = [pt.__dict__ for pt in weak_scaling_report(graph=args.graph,
                                                         trace_dir=args.trace_dir,
                                                         device=args.device)]
    if comm.is_main():
        print(json.dumps(out, indent=1))
    if comm.is_initialized():
        comm.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
