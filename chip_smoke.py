#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --plant-faults   # the distributed phase's bounds

Phases, each printing one JSON line as it ends:

0. device: the card's name and power limit (as nvidia-smi prints them), and
   the nvcc builds of csrc/hyper.cu (K1/K2), csrc/ell.cu (the ELL kernels)
   csrc/retile.cu (pack/unpack), csrc/optim.cu (Adam, the sum of
   squares), csrc/gat.cu (GAT's attention) and csrc/epilogue.cu (the
   DirectGCN layer's tail), started together, with their times,
   ptxas's registers and spills, and the ELL plans' occupancy; then
   ``python -m protgram_directgcn_torch.doctor`` in a process of its own,
   started here and read after phase 2, every check ``[ok]`` (phase
   ``doctor``);
1. kernels: K1 and K2, forward and the bank-swapped backward, held against
   their plain PyTorch versions at the main path's shapes (A=21, G=441 and
   21, F=256/128/64/32, float32 and bfloat16), at the 5-gram hypercube
   (A=21, G=194,481, F=64/128/256, bfloat16), at A=26 with widths that take
   no 16-byte access (F=100 bfloat16, F=37 float32), and with x a view one
   element past an aligned start (A=21, G=441, F=256, both types); each
   timed on the device (launches captured in a CUDA graph, replays timed
   with CUDA events) beside the one-call ``torch.einsum`` of the same
   contraction and its plain version (at the 5-gram shape only at F=128),
   and through its Python wrapper in a host loop (``wrapper_ms``); and K2
   with a gc operand of its own (``x_gc``, as a key shard's K2 reads the
   block its exchange delivered) at the n = 4 level's shard at world size 2
   (A=21, Gd=4,631, F=256/128/64, both types) against ``k2_plain`` with the
   same operand (phase ``kernels_k2_gc``);
2. main path: ``python -m protgram_directgcn_torch --stages graph,gcn``'s
   entry point on a seeded synthetic FASTA of Swiss-Prot-like size (20,000
   sequences, lengths 50-1,000), dims [256, 128, 64], n = 1..3, five epochs a
   level, with the K1/K2 launch counts set to 0 before and read after; every
   other knob at its default, so the PPI sanity check runs on the 64-column
   PCA file over seeded interaction files (100,000 positive and 200,000
   negative pairs of the FASTA's accessions): a [128 -> 64 -> 32 -> 1] MLP,
   10 epochs on 160,000 pairs at batch 1,024 (phase ``sanity_check``);
2a. word2vec: ``--stages word2vec`` on the same FASTA and ``--out`` at every
   default (dim 100, window 5, batch 8,192, sample 1e-3) but 2 epochs: steps,
   final loss, host sampling and device seconds, one finite vector per
   protein, the ``.vectors.bin`` read back equal;
2a'. transformer: ``--stages transformer`` on the same FASTA and ``--out``
   (``main.py``'s order: before ``ppi``); no checkpoint loads on the card's
   machine, so the stage writes the seeded residue-projection fallback: one
   finite 64-wide vector a protein, equal to the CPU's;
2b. ppi: ``--stages ppi`` over the five sets the three stages wrote (GCN
   and Word2Vec, each raw and PCA, and the transformer's), 100,000 sampled
   negatives, batch 1,024, ``eval.n_folds`` cut from 5 to 3 and
   ``eval.epochs`` from 300 to 2: a finite AUC a set, a
   Wilcoxon row for each set but the main one, seconds and MLP steps per
   second a set;
2c. ppi reference: one fold's MLP at the default widths (dropout 0), 3
   epochs on the card and on the CPU from the same parameters, the
   probabilities within rtol 1e-4, atol 1e-6; one skip-gram epoch on a
   300-sequence FASTA on both, the vectors within rtol 1e-4, atol 1e-7;
3. reference: the model's forward and gradients on the card against the
   port's CPU path (which the CPU tests hold against the JAX package) on a
   small n = 3 hypercube graph;
4. ell path: the same entry point on the same FASTA with
   ``gcn.spmm_mode=pallas`` (ELL operators at every level), n = 1..4, 10
   epochs a level (so that the n = 4 level's step time, ``level4_step_seconds``,
   is not mostly the first step's warm-up)
   (``gcn.use_cluster_training=false``: the n = 4 level trains full batch,
   the step this phase times; ``gcn.default_task_type=closest_aa`` for the
   n = 4 level, so that its step is not the cluster path's;
   ``next_node`` there would need a [N, N] decoder output, 112 GB at
   167,325 nodes),
   with the ELL kernels' launch counts set to 0 before and read after:
   levels 1-3 must run ``ell_resident`` and level 4 ``ell_hbm``, forward and
   backward;
5. ell kernels: ``ell_resident`` at the ell path's n = 3 operator and
   ``ell_hbm`` at its n = 4 operator (𝒜_in, K as built), F = 64, 128, 256,
   f32, forward and the transpose-orientation backward, held against their
   plain versions and timed like K1/K2, beside one ``torch.sparse.mm`` on a
   CSR copy of the operator, with the gathered rows' bytes and rate; the
   transpose orientation timed at F = 256; 𝒜_out and the undirected
   operator at n = 4, F = 256; edge cases (F = 37, x one element past an
   aligned start, K = 150 past one staging pass with N_out = 1,003, rows of
   padding only, a random ELL at the n = 4 size, timed), each launch's
   variant (16-byte or one-element path) checked; ``spmm.propagate`` on a
   CUDA ``EllAdj`` and ``BucketedEllAdj`` (the formats ``gcn.spmm_mode``
   "ell" and "bucketed" build) launching the kernels forward and backward
   and never the plain version;
6. ell reference: phase 3 on ELL operators through the ELL kernels;
7. cluster path: the same entry point on the same FASTA with
   ``gcn.spmm_mode=pallas`` at n = 1..4, 2 epochs a level, and every other
   knob at its default: n <= 3 full batch through ``ell_resident``; the
   n = 4 level (167,325 nodes, above ``cluster_training_threshold_nodes``)
   on its default task, Louvain communities (the C++ sweep), and on
   Cluster-GCN batches (335 BFS clusters of at most 500 nodes, dense
   [budget, budget] blocks, device-resident), its eval pass through
   ``ell_hbm``; the pooled embeddings and their 64-column PCA written
   (``.npz`` where h5py is absent) and read back; the Louvain, batch build
   and n = 4 step times;
8. louvain: the C++ Louvain sweep against the numpy sweep on the n = 3
   graph (8,401 nodes): byte-equal labels, both times;
9. cluster reference: one train step's loss and gradients on three n = 4
   batches of each block format (dense, and padded ELL through
   ``ell_resident``), card against the port's CPU path;
10. tier reference: phase 3 at memory tiers 1, 2 and 3 (remat; bf16 compute
   and node tables; per-path remat with the packed carry, so pack and
   unpack run on the card), card against the port's CPU path;
11. retile kernels: pack and unpack at the 5-gram tier-3 carry (A = 21,
   G = 194,481 padded to 194,482, f = 64), float32 and bfloat16, the
   exact-width and the 128-padded pack input, forward and the autograd
   backward, held bit for bit against their plain versions; timed like
   K1/K2, beside one PyTorch call of the same function; then
   ``optim_kernels``: Adam and the sum of squares over the benchmark cells'
   parameters (n = 4, dims [256, 128, 64], 194,481 and 167,325 node rows,
   f32) and over the tier path's 5-gram level at tier 2 (4,084,101 rows,
   bf16 node tables), one step against the plain versions, and timed.
   Every level the smoke trains through ``train_level`` on one card must
   read in ``level_stats[n]["optimizer"]`` every Adam leaf updated by the
   Adam kernel and none by the plain version;
   ``epilogue_kernels``: the DirectGCN layer's tail (``csrc/epilogue.cu``:
   bias adds, gating, constant, residual, leaky ReLU, dropout, one kernel
   each way) at the benchmark cells' layer outputs (194,481 rows as the
   rg carry [21, 9261, F], 167,325 flat; F = 256 / 128 / 64), forward
   equal to the plain ATen chain to the bit, the backward's path
   cotangents and ``ds`` to the bit and its gate and bias sums within
   ``EPILOGUE_SUM_RTOL``; each way timed beside the plain chain's forward
   and forward-and-backward and the bound (62 bytes an element).  The
   main, ell, cluster and tier paths' DirectGCN levels must read in
   ``level_stats[n]["epilogue"]`` the route the engage rule gives: the
   kernels (two launches a layer a step at tier 0), the plain chain at the
   5-gram level's bf16 tier 3; the distributed phase's feature-sharded
   levels the plain chain;
   ``gat``: GAT's attention (``csrc/gat.cu``: the edge softmax, the
   aggregation both ways, the edge gradient) on the n = 4 level's in-edge
   table (3,263,383 edges with the self loops) at the PPI model's layer
   shapes, 4 heads x 256 and 6 x 121, forward and backward against the
   plain versions and the benchmark's reference (``perfbench/reference/
   gat.py``) within ``GAT_TOL``, then timed beside the bound;
12. tier path: the entry point with ``graph_builder.ngram_max_n=5``, dims
   [256, 128, 64], ``gcn.default_task_type=closest_aa`` and the plan's
   device budget pinned to 32 GiB (``HierarchicalTrainer._hbm_override``),
   at which the plan keeps n = 1..4 at tier 0 and puts the 5-gram level
   (4,084,101 hypercube nodes) at tier 3; each level's plan and peak
   device allocation, and K1/K2/pack/unpack launches in the n = 5 level's
   training;
13. tier plan from free memory: the 5-gram level trained again through
   ``HierarchicalTrainer.train_level`` with no pin, at the tier the plan
   picks from the card's real free memory; its plan, each tier's residency
   estimate and the measured peak beside the tier-3 peak of phase 12;
14. native ETL: the FASTA's n = 1..4 graphs built by the C++ ETL and by
   numpy, byte for byte equal, with both times (every path's graph stage
   above must have taken the C++ ETL at every level);
15. checkpoint: the main path's n = 3 level through ``train_level`` with
   ``gcn.checkpoint_every_epochs=2``, cut after 4 epochs and resumed to 6,
   against an uncut 6-epoch run; the ``metrics.jsonl`` lines of both; and
   three float32 steps of the staged step (tier 4) against the fused one
   at n = 3;
16. tier-4 level: the tier path's 5-gram level through ``train_level`` with
   the plan's budget pinned between its tier-4 and tier-3 needs: tier 4
   (the layer-staged step), K1/K2/pack/unpack launched forward and backward,
   its peak beside phase 12's tier-3 peak, and the byte model's tier-3 and
   tier-4 needs at Swiss-Prot's 5-gram level (26^5 hypercube nodes).  It
   reuses phase 13's operators (the same bf16 banks) in place of a second
   host build;
17. degrade level: the tier path's 4-gram level with the budget pinned below
   its tier-4 need: the plan halves the dims and the level trains at them;
18. benchmark: ``--stages benchmark`` at every default (the seven datasets,
   seeded stand-ins where raw files are absent, both variants, the seven
   zoo models at their widths and the three DirectGCN rows) but
   ``benchmark.epochs`` cut from 300 to 5 and ``benchmark.n_seeds`` from 10
   to 2, each model's training under ``torch.profiler``, with the ELL
   kernels' launch counts set to 0 before and read after: no ``error`` row,
   finite accuracies, both ELL kernels launched both ways; per dataset and
   model the wall seconds, steps a second, device busy share and operator
   formats; the stand-ins' ``hash(name) % 1000`` seed offsets of this
   process; then ``ell_resident`` (Cora's ChebNet Laplacian, negative
   weights) and ``ell_hbm`` (PubMed's GCN operator) at F = 2, 3, 5, 6, 7
   and 34 (v = 1), both ways, against the plain versions and timed
   (phase ``bench_ell_kernels``); and one model a format (dense, ELL,
   bucketed ELL), five epochs of ``train_and_evaluate`` on the card and on
   the CPU from the same parameters, dropout 0 (phase
   ``bench_reference``).

19. sddmm: ``propagate(adj, x, edge_grads=True)`` on the card against the
   same call on the CPU: dw and dx of the ELL format at n = 4 (through
   ``ell_hbm``), bucketed ELL and COO at n = 3 (F = 64), the hypercube's
   dd, dwf and dwb at n = 3 (F = 256, float32 and bfloat16); the ELL
   products launch the kernels both ways and never ``ell_plain``; the
   kernel forward, the SDDMM alone and a forward and backward with and
   without edge gradients timed (the SDDMM's share of the backward);
20. distributed: the ell path's graphs n = 1..4 trained over node shards
   (``HierarchicalTrainer.run`` under ``parallel.mesh_nodes``, dims
   [256, 128, 64], 5 epochs, dropout 0, closest_aa at n = 4), in hypercube
   mode (n = 1 in halo mode) and in halo mode: at world size 1 under NCCL
   in this process, and at world size 2 under gloo in two spawned
   processes that share the card, after a probe (in two more processes) of
   whether gloo takes CUDA tensors for ``all_to_all_single``,
   ``all_reduce`` and ``batch_isend_irecv``; each run's losses and exported
   embeddings held against the one-device run from the same initial
   parameters; K1/K2 on every hypercube level and the ELL kernels on every
   halo level launched both ways; step, exchange and launch counts per
   level and rank;
20a. gspmd: the same levels in ``parallel.mode=gspmd`` (the ELL tables'
   row blocks over gathered features) at world size 1 under NCCL and 2
   under gloo, against the one-device ELL run: ``ell_resident`` at
   n <= 3 and ``ell_hbm`` at n = 4 both ways on every rank, the plain
   version never, and the all-gathers' calls, bytes and seconds;
20b. feat: n = 1..3 over 1 node shard x 2 feature shards
   (``parallel.mesh_feats=2``) at world size 2 under gloo, hypercube and
   gspmd modes, full width (each rank propagates F = 128/64/32), against
   the one-device run; K1/K2 (their widths recorded) and the ELL kernels
   launched both ways on every rank.  The world-size-2 runs of 20-20b run
   in one spawn, kind after kind;
21. scaling: ``bench/scaling.py``'s ``weak_scaling_report`` (ngram, 4,096
   nodes a shard) and ``hyper_shard_scaling_report`` (512 keys a shard) at
   D = 1 and 2 under gloo on the card (a path check: the two ranks share
   one card and gloo's exchanges pass through host memory) and at D = 1
   under NCCL, and ``fivegram_scaling_report``'s five curves at D = 1 on the
   ell path's n = 4 level (167,325 nodes; on the tier path's 5-gram level
   the five curves took 74 s, over the phase's 60 s): each curve's ms a
   step and edges a second.

``--plant-faults`` runs the distributed phase's world-size-2 runs, each
with one planted fault (the halo receive buffer zeroed; a key shard's gc
block shifted by one key; each rank's node-parameter slab shifted by one
row; the gspmd ELL tables' row blocks shifted by one row; feature rank 1
given rank 0's columns of ``w_main_in``), a control (the one-device run with each ELL row's slots in reverse
order: the same products summed in another order) and the sound runs, all
held against the one-device references, and prints their readings beside
the phase's bounds (phase ``distributed_bounds``).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
then exits non-zero without that last line.  It exits non-zero at once when
no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

T0 = time.monotonic()
DEVICE = "cuda"
N_SEQS = 20_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # non-tensor f32; dense bf16
F32_TOL = (1e-5, 1e-5)  # rtol, atol
BF16_REL_TO_MAX = 0.05  # max |err| <= 0.05 * max |ref| (tests/test_hypercube.py:160)
# F = 32: the feature shards' last layer (dims [256, 128, 64] over 2 shards).
MAIN_SHAPES = [(21, g, f) for g in (441, 21) for f in (256, 128, 64, 32)]
LARGE_SHAPE = (21, 194_481, 128)
LARGE_WIDTHS = (64, 128, 256)  # the widths the 5-gram level's propagations take
# Swiss-Prot's alphabet (25 letters and the space) at its n = 3 key count, at
# widths that 16-byte accesses cannot take: the kernels' one-element path.
RAGGED_SHAPES = [((26, 676, 100), "bfloat16"), ((26, 676, 37), "float32")]
MISALIGNED_SHAPE = (21, 441, 256)  # x a contiguous view one element past an aligned start
ELL_WIDTHS = (32, 64, 128, 256)  # 32: the feature shards' last layer
# Depths cut to hold the smoke's time as phases were added (PERF.md §4
# gives the depths they replaced):
ELL_PATH_EPOCHS = 10  # epochs a level on the ell path
CLUSTER_PATH_EPOCHS = 2
W2V_EPOCHS = 2  # word2vec.epochs cut from 5
# The optimizer kernels' cases, at input width 64 and dims [256, 128, 64]:
# (node rows, n, node-table type).  The benchmark cells' n = 4 level over the
# hypercube's rows or the vocabulary (f32), and the tier path's 5-gram level
# at tier 2 (the free-memory level: bf16 node tables in the Adam group, the
# layer-1 constant [21, 194,481, 256] of 1.05e9 elements).
OPTIM_CASES = {"hyper.ngram4": (21**4, 4, "float32"), "ell.ngram4": (167_325, 4, "float32"),
               "tier2.ngram5": (21**5, 5, "bfloat16")}
OPTIM_DIMS = (64, 256, 128, 64)
# The layer tail's cases: the benchmark cells' layer outputs.
EPILOGUE_SHAPES = {"hyper.ngram4": [(21, 9261, f) for f in (256, 128, 64)],
                   "ell.ngram4": [(167_325, f) for f in (256, 128, 64)]}
EPILOGUE_SUM_RTOL = 1e-5  # the gate and bias sums' allowance, a share of the largest
EPILOGUE_BYTES = 62  # an element, both ways (csrc/epilogue.cu)
RETILE_CARRY = (21, 194_481, 64)  # A, G, f: the 5-gram level's last layer at [256, 128, 64]
TIER_N = 5
TIER_DIMS = (256, 128, 64)
TIER_PIN = 32 << 30  # n = 1..4 fit tier 0 and the 5-gram level tier 3 (PERF.md)
TIER_CLASSES = 4  # closest_aa with closest_aa_k_hops = 3
SWISSPROT_HYPER_NODES = 26**5  # 25 letters and the space at n = 5
CHECKPOINT_EVERY = 2
N_POSITIVE_PAIRS = 100_000  # seeded interaction pairs over the FASTA's accessions
N_NEGATIVE_PAIRS = 200_000
PPI_EPOCHS = 2  # eval.epochs cut from 300: ~2.5 ms host-bound MLP steps
PPI_FOLDS = 3  # eval.n_folds cut from 5
PPI_REF_PAIRS = 20_000  # the ppi_reference phase's pairs (one fold of 5 held out)
PPI_REF_EPOCHS = 3
PPI_REF_TOL = (1e-4, 1e-6)  # rtol, atol of the card's probabilities against the CPU's
W2V_REF_TOL = (1e-4, 1e-7)  # rtol, atol of the card's skip-gram vectors against the CPU's
W2V_REF_SEQS = 300
BF16_GRAD_NORM_REL = 0.25  # tests/test_torch_tiers.py
# benchmark.epochs cut from 300 and benchmark.n_seeds from 10 (KarateClub's rows) to
# keep the phase near 180 s: at 50 and 3 it took 252-268 s (PERF.md), ~93 s of it
# the embeddings and PCA writes, which the cut does not shorten.
BENCH_EPOCHS = 5
BENCH_SEEDS = 2
BENCH_WIDTHS = (2, 3, 5, 6, 7, 34)  # the class counts and KarateClub's identity features
BENCH_REF_EPOCHS = 5
BENCH_REF_TOL = (1e-4, 2e-3, 1e-3)  # loss rtol; an element's allowance in lr a step; share past it
SOURCES = {
    "hyper_k1": "protgram_directgcn_torch/csrc/hyper.cu",
    "hyper_k2": "protgram_directgcn_torch/csrc/hyper.cu",
    "ell_resident": "protgram_directgcn_torch/csrc/ell.cu",
    "ell_hbm": "protgram_directgcn_torch/csrc/ell.cu",
    "retile_unpack": "protgram_directgcn_torch/csrc/retile.cu",
    "retile_pack": "protgram_directgcn_torch/csrc/retile.cu",
}
REPLACES = {
    "hyper_k1": "protgram_directgcn_tpu/ops/pallas_hyper.py:217",
    "hyper_k2": "protgram_directgcn_tpu/ops/pallas_hyper.py:245",
    "ell_resident": "protgram_directgcn_tpu/ops/pallas_spmm.py:72",
    "ell_hbm": "protgram_directgcn_tpu/ops/pallas_spmm.py:204",
    "retile_unpack": "protgram_directgcn_tpu/ops/pallas_retile.py:78",
    "retile_pack": "protgram_directgcn_tpu/ops/pallas_retile.py:109",
}


def emit(phase: str, **fields) -> None:
    """One JSON line, with the bytes still allocated on the card as it ends."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_available():
        fields.setdefault("device_allocated_bytes", torch.cuda.memory_allocated())
    print(json.dumps({"phase": phase, "elapsed_s": round(time.monotonic() - T0, 3), **fields}),
          flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check_epilogue_route(where: str, st: dict, fused: bool = True) -> None:
    """A trained DirectGCN level's ``level_stats[n]["epilogue"]`` on the
    card: every layer's tail through the kernels of ``csrc/epilogue.cu``
    where ``fused``, two launches a layer a step (more under remat, which
    runs the forward again), else the plain chain and no launch."""
    epi = st["epilogue"]
    want = 2 * (len(st["layer_dims"]) - 1) * st["steps"]
    if fused:
        ok = epi["route"] == "fused" and (
            epi["launches"] == want or (st["plan"]["remat"] and epi["launches"] > want))
    else:
        ok = epi == {"route": "plain", "launches": 0}
    if not ok:
        fail(f"{where}: layer tail {epi}, expected the {'fused' if fused else 'plain'} route"
             f"{f' with {want} launches' if fused else ''}")


def check_optimizer_routes(where: str, st: dict, adafactor: bool = False) -> None:
    """A trained level's ``level_stats[n]["optimizer"]`` on the card: every
    Adam leaf updated by the fused kernel (``csrc/optim.cu``), none by the
    plain version, the Adam kernel launched, and the Adafactor group (the
    factored node tables of tiers 3-4) used where ``adafactor``."""
    opt = st["optimizer"]
    if (opt["plain"]["leaves"] != 0 or opt["fused"]["leaves"] <= 0
            or opt["launches"]["adam"] <= 0 or (opt["adafactor"]["leaves"] > 0) != adafactor):
        fail(f"{where}: optimizer routes {opt}")


# -----------------------------------------------------------------------------
# Phase 1: kernels
# -----------------------------------------------------------------------------


_SIDE_STREAM = []  # the one side stream of every capture


def _device_ms(torch, fn, iters: int, replays: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph,
    replayed ``replays`` times after a warm-up replay, timed with CUDA
    events.  The host's cost of issuing each call is outside the graph.
    Every capture shares one side stream: cuBLAS keeps a workspace for each
    stream it has run on (64 MiB here) and never frees it, so a stream a
    call left ~1.1 GB allocated on the card after the kernel phase, inside
    every later peak."""
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture (library handles, allocator)
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def _wrapper_ms(torch, fn, iters: int) -> float:
    """Mean time of one call issued from a host loop: where a launch is
    shorter than the wrapper's own cost, this is the host's issue rate."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(kernel: str, a: int, g: int, f: int, dtype: str):
    """Least time the card needs: each input read once, each output written
    once, at the HBM rate; or the operations at the peak rate of the input
    type, whichever is larger."""
    it = 4 if dtype == "float32" else 2
    carry, bank = a * g * f * it, a * g * a * it
    if kernel == "hyper_k1":  # read x, w1; write z
        nbytes, ops = 2 * carry + bank, 2 * a * a * g * f
    else:  # read d, w2, z, x; write out
        nbytes, ops = 3 * carry + bank + a * g * 4, 2 * a * a * g * f + 5 * a * g * f
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _err(torch, got, ref, dtype: str):
    err = (got.float() - ref.float()).abs()
    if dtype == "float32":
        rtol, atol = F32_TOL
        ok = bool((err <= atol + rtol * ref.float().abs()).all())
    else:
        ok = float(err.max()) <= BF16_REL_TO_MAX * float(ref.float().abs().max())
    return float(err.max()), ok


def _kernel_cases():
    """(shape, dtype, misaligned, time the plain versions) of every K1/K2 check."""
    cases = [(s, dt, False, True) for s in MAIN_SHAPES for dt in ("float32", "bfloat16")]
    a, g, f_main = LARGE_SHAPE
    cases += [((a, g, f), "bfloat16", False, f == f_main) for f in LARGE_WIDTHS]
    cases += [(s, dt, False, True) for s, dt in RAGGED_SHAPES]
    cases += [(MISALIGNED_SHAPE, dt, True, True) for dt in ("float32", "bfloat16")]
    return cases


def check_kernels(torch, hk, hyper):
    """Hold K1/K2 (forward and swapped-bank backward) against the plain
    versions; time them.  Returns per-shape records."""
    records = []
    for (a, g, f), dt, misaligned, time_plain in _kernel_cases():
        tdt = getattr(torch, dt)
        gen = torch.Generator(device=DEVICE).manual_seed(a * 1_000_003 + g * 1009 + f)
        off = 1 if misaligned else 0
        base = torch.randn(a * g * f + off, device=DEVICE, generator=gen).to(tdt)
        x = base[off:].view(a, g, f)
        wf = torch.randn(a, g, a, device=DEVICE, generator=gen).to(tdt)
        wb = torch.randn(a, g, a, device=DEVICE, generator=gen).to(tdt)
        d = torch.randn(a, g, device=DEVICE, generator=gen)
        cot = torch.randn(a, g, f, device=DEVICE, generator=gen).to(tdt)
        scale, shift = 0.75, 0.125

        hk.reset_launches()
        z = hk.k1(wf, x)
        out = hk.k2(d, wb, z.view(a, g, f), x, scale, shift)
        adj = hyper.HypercubeAdj(d=d, wf_rs=wf, wb_rs=wb,
                                 node_map=torch.arange(a * g, device=DEVICE))
        leaf = base.clone().requires_grad_(True)  # the same offset as x
        y = hyper.propagate_hyper_affine(adj, leaf[off:].view(a, g, f), scale, shift)
        y.backward(cot)
        torch.cuda.synchronize()
        dx = leaf.grad[off:].view(a, g, f)
        # The case's three launches of each kernel (direct, forward, backward)
        # by the features a thread owns: the one-element path exactly where
        # 16-byte access is impossible.  A misaligned x takes it in the two
        # launches on x; the backward's are on the aligned cotangent.
        by_v = hk.launch_counts_by_v()
        vec = 16 // tdt.itemsize
        want = ({1: 3} if f * tdt.itemsize % 16 else {1: 2, vec: 1} if misaligned else {vec: 3})
        for k, counts in by_v.items():
            if counts != want:
                fail(f"{k} at A={a} G={g} F={f} {dt} misaligned={misaligned} launched "
                     f"{counts} by features a thread, expected {want}")

        z_ref = hk.k1_plain(wf, x)
        out_ref = hk.k2_plain(d, wb, z.view(a, g, f), x, scale, shift)
        y_ref = hk.k2_plain(d, wb, z_ref.view(a, g, f), x, scale, shift)
        dx_ref = hk.k2_plain(d, wf, hk.k1_plain(wb, cot).view(a, g, f), cot, scale, 0.0)
        rec = {"shape": [a, g, f], "dtype": dt, "misaligned": misaligned,
               "launches_by_v": {k: {str(v): n for v, n in c.items()} for k, c in by_v.items()}}
        for name, got, ref in (("k1", z, z_ref), ("k2", out, out_ref),
                               ("fwd", y.detach(), y_ref), ("bwd", dx, dx_ref)):
            err, ok = _err(torch, got, ref, dt)
            rec[f"{name}_max_abs_err"] = err
            if not ok:
                fail(f"{name} disagrees with its plain version at A={a} G={g} F={f} {dt} "
                     f"misaligned={misaligned}: max abs err {err}")
            if not bool(torch.isfinite(got.float()).all()):
                fail(f"{name} produced non-finite values at A={a} G={g} F={f} {dt}")

        iters = 20 if g * f > 10_000_000 else 200
        zv = z.view(a, g, f)
        x_gc = x.view(g, a, f)
        fns = {
            "k1": lambda: hk.k1(wf, x),
            "k2": lambda: hk.k2(d, wb, zv, x, scale, shift),
            "k1_library": lambda: torch.einsum("rgc,rgf->gcf", wf, x),
            "k2_library": lambda: torch.einsum("rgc,gcf->rgf", wb, x_gc),
        }
        if time_plain:
            fns["k1_plain"] = lambda: hk.k1_plain(wf, x)
            fns["k2_plain"] = lambda: hk.k2_plain(d, wb, zv, x, scale, shift)
        for key, fn in fns.items():
            rec[f"{key}_ms"] = _device_ms(torch, fn, iters)
        for k in ("k1", "k2"):
            rec[f"{k}_wrapper_ms"] = _wrapper_ms(torch, fns[k], iters)
        for k in ("hyper_k1", "hyper_k2"):
            rec[f"{k[-2:]}_bound_ms"], rec[f"{k[-2:]}_bound_by"] = _bound(k, a, g, f, dt)
        emit("kernels", **rec)
        records.append(rec)
        del base, x, wf, wb, d, cot, z, out, leaf, y, dx, z_ref, out_ref, y_ref, dx_ref, adj, fns
        torch.cuda.empty_cache()
    return records


# A key shard's K2 (parallel/hyper_shard.py) reads its gc term from the block
# the exchange delivered: the n = 4 level's shard at world size 2 (G = 21^3
# keys over two ranks) at the distributed phase's widths.
K2_GC_SHAPES = [(21, -(-21**3 // 2), f) for f in (256, 128, 64)]


def check_k2_gc(torch, hk) -> dict:
    """K2 with ``x_gc`` distinct from x against ``k2_plain`` with the same
    operand, float32 and bfloat16: max abs error by type and width."""
    errs = {}
    for a, g, f in K2_GC_SHAPES:
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            gen = torch.Generator(device=DEVICE).manual_seed(a * 7 + g + f)
            x, z = (torch.randn(a, g, f, device=DEVICE, generator=gen).to(tdt) for _ in "xz")
            gc = torch.randn(g, a, f, device=DEVICE, generator=gen).to(tdt)
            w2 = torch.randn(a, g, a, device=DEVICE, generator=gen).to(tdt)
            d = torch.randn(a, g, device=DEVICE, generator=gen)
            got = hk.k2(d, w2, z, x, 0.75, 0.125, x_gc=gc)
            err, ok = _err(torch, got, hk.k2_plain(d, w2, z, x, 0.75, 0.125, x_gc=gc), dt)
            if not ok or not bool(torch.isfinite(got.float()).all()):
                fail(f"k2 with x_gc disagrees with its plain version at A={a} G={g} F={f} {dt}: "
                     f"max abs err {err}")
            errs.setdefault(dt, {})[str(f)] = err
            del x, z, gc, w2, d, got
    emit("kernels_k2_gc", shape=list(K2_GC_SHAPES[0][:2]), max_abs_err=errs)
    torch.cuda.empty_cache()
    return {"shape": list(K2_GC_SHAPES[0][:2]), "max_abs_err_by_dtype_and_f": errs}


# -----------------------------------------------------------------------------
# Phase 2: main path
# -----------------------------------------------------------------------------


def write_fasta(path: str, n_seqs: int, seed: int, lo: int, hi: int) -> int:
    """Seeded FASTA over the 20 standard amino acids with ``sp|ID|...``
    headers; returns the residue count."""
    import numpy as np

    rng = np.random.default_rng(seed)
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    lens = rng.integers(lo, hi + 1, n_seqs)
    residues = aa[rng.integers(0, 20, int(lens.sum()))].tobytes().decode()
    pos = 0
    with open(path, "w") as fh:
        for i, n in enumerate(lens.tolist()):
            seq = residues[pos : pos + n]
            pos += n
            fh.write(f">sp|A{i:05d}|SYN{i}_HUMAN Synthetic protein {i}\n")
            fh.write("\n".join(seq[j : j + 60] for j in range(0, n, 60)) + "\n")
    return int(lens.sum())


def _finite(values) -> bool:
    return all(v == v and abs(v) != float("inf") for v in values)


def _drive(torch, argv):
    """The CLI's entry point on ``argv``; returns (result, wall seconds)."""
    from protgram_directgcn_torch.__main__ import main

    t0 = time.monotonic()
    result = main(argv)
    torch.cuda.synchronize()
    return result, time.monotonic() - t0


def _native_etl(result, path: str) -> dict:
    """Fail unless every level of a run's graph stage took the C++ ETL;
    return its seconds by level."""
    etl = result["graph_etl"]
    fell_back = {n: st["etl"] for n, st in etl.items() if st["etl"] != "native"}
    if fell_back or not etl:
        fail(f"{path}: the graph stage fell back to numpy at levels {fell_back}")
    return {str(n): st["seconds"] for n, st in etl.items()}


def _pooled(result, dim: int) -> dict:
    """Check one finite ``dim``-wide pooled vector per protein."""
    import numpy as np

    pooled = result["pooled"]
    vecs = np.stack(list(pooled.values()))
    if len(pooled) != N_SEQS or vecs.shape != (N_SEQS, dim) or not np.isfinite(vecs).all():
        fail(f"pooled embeddings: {len(pooled)} proteins, shape {vecs.shape}, "
             f"finite={bool(np.isfinite(vecs).all())}")
    return {"proteins": len(pooled), "pooled_dim": int(vecs.shape[1]),
            "stage_seconds": result["seconds"],
            "pool_seconds": result["trainer"].pool_seconds}


def write_pairs(path: str, n_pairs: int, n_seqs: int, seed: int) -> None:
    """Seeded interaction CSV of ``n_pairs`` distinct-protein pairs over the
    synthetic FASTA's accessions ``A00000``..."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = rng.integers(0, n_seqs, n_pairs)
    b = (a + rng.integers(1, n_seqs, n_pairs)) % n_seqs
    with open(path, "w") as fh:
        fh.write("".join(f"A{i:05d},A{j:05d}\n" for i, j in zip(a.tolist(), b.tolist())))


def _interaction_args(workdir: str):
    return ["--set", f"paths.interactions_positive={os.path.join(workdir, 'positive.csv')}",
            "--set", f"paths.interactions_negative={os.path.join(workdir, 'negative.csv')}"]


def run_main_path(torch, hk, fasta: str, workdir: str):
    """``--stages graph,gcn`` at n = 1..3, 5 epochs a level, every other knob
    at its default: the PPI sanity check runs on the 64-column PCA file."""
    argv = ["--fasta", fasta, "--out", os.path.join(workdir, "out"), "--stages", "graph,gcn",
            "--set", "gcn.hidden_layer_dims=[256,128,64]",
            "--set", "graph_builder.ngram_max_n=3",
            "--set", "gcn.epochs_per_level=5",
            *_interaction_args(workdir),
            "--device", DEVICE]
    hk.reset_launches()
    result, seconds = _drive(torch, argv)
    counts = hk.launch_counts()

    stats = result["trainer"].level_stats
    for n in (1, 2, 3):
        if n not in stats:
            fail(f"level n={n} did not train")
        st = stats[n]
        if not _finite(st["losses"]):
            fail(f"level n={n} has non-finite losses {st['losses']}")
        check_optimizer_routes(f"main path n={n}", st)
        check_epilogue_route(f"main path n={n}", st)
        emit("main_path_level", level=n, **st)
    if stats[1]["route"] != "dense":
        fail("level n=1 should take the dense route")
    for n in (2, 3):
        st = stats[n]
        if st["route"] != "hypercube":
            fail(f"level n={n} took the {st['route']} route, not hypercube")
        for k in ("k1", "k2"):
            for direction in ("fwd", "bwd"):
                if st["launches"][k][direction] <= 0:
                    fail(f"level n={n}: {k} {direction} was never launched")
    emit("main_path", seconds=seconds, launches=counts,
         graph_etl_seconds=_native_etl(result, "main path"), **_pooled(result, 64))
    trainer = result["trainer"]
    metrics, stats = trainer.sanity_metrics, trainer.sanity_stats
    if metrics is None or not _finite(metrics.values()):
        fail(f"the PPI sanity check was skipped or not finite: {metrics}")
    if not result["embeddings_path"].endswith("_pca64.npz"):
        fail(f"the sanity check read {result['embeddings_path']}, not the 64-column PCA file")
    emit("sanity_check", embeddings=os.path.basename(result["embeddings_path"]), **metrics,
         **stats, steps_per_second=stats["steps"] / stats["fit_seconds"])
    return counts, result["graphs"], result["embeddings_path"]


# -----------------------------------------------------------------------------
# The Word2Vec and PPI stages
# -----------------------------------------------------------------------------


def run_word2vec(torch, fasta: str, workdir: str) -> dict:
    """``--stages word2vec`` on the main path's FASTA and ``--out``, every
    knob at its default (dim 100, window 5, batch 8,192, sample 1e-3) but
    ``word2vec.epochs`` (cut to ``W2V_EPOCHS``): one finite pooled vector
    per protein, and the ``.vectors.bin`` read back equal to the model's
    input table."""
    import numpy as np

    from protgram_directgcn_torch.pipeline.word2vec import SkipGramModel
    from protgram_directgcn_torch.utils.io import read_embeddings

    argv = ["--fasta", fasta, "--out", os.path.join(workdir, "out"), "--stages", "word2vec",
            "--set", f"word2vec.epochs={W2V_EPOCHS}", "--device", DEVICE]
    result, seconds = _drive(torch, argv)
    emb = result["embedder"]
    st = emb.stats
    pooled = read_embeddings(result["word2vec_path"])
    vecs = np.stack(list(pooled.values()))
    if len(pooled) != N_SEQS or vecs.shape[1] != 100 or not np.isfinite(vecs).all():
        fail(f"word2vec: {len(pooled)} proteins, shape {vecs.shape}")
    bin_path = next(f for f in st["files"] if f.endswith(".vectors.bin"))
    back = SkipGramModel.load_word2vec_format(bin_path, device="cpu")
    if back.vocab != emb.model.vocab or not np.array_equal(back.vectors(), emb.model.vectors()):
        fail("word2vec: the .vectors.bin does not read back equal")
    if not (st["steps"] > 0 and _finite([st["final_loss"]])):
        fail(f"word2vec: {st['steps']} steps, final loss {st['final_loss']}")
    emit("word2vec", wall_seconds=seconds, proteins=len(pooled),
         files=[os.path.basename(f) for f in st["files"]],
         **{k: v for k, v in st.items() if k != "files"})
    return st


def run_ppi(torch, workdir: str) -> dict:
    """``--stages ppi`` over the main path's, the word2vec phase's and the
    transformer phase's files (5 sets), the defaults but ``eval.epochs``
    and ``eval.n_folds`` (cut to ``PPI_EPOCHS``, ``PPI_FOLDS``): one finite
    ``test_auc`` a set in
    ``ppi_results.json``, and a Wilcoxon row in ``evaluation_summary.txt``
    for each set but the main one."""
    out = os.path.join(workdir, "out")
    argv = ["--out", out, "--stages", "ppi", "--set", f"eval.epochs={PPI_EPOCHS}",
            "--set", f"eval.n_folds={PPI_FOLDS}", *_interaction_args(workdir),
            "--device", DEVICE]
    result, seconds = _drive(torch, argv)
    eval_dir = os.path.join(out, "3_evaluation_results")
    with open(os.path.join(eval_dir, "ppi_results.json")) as fh:
        saved = json.load(fh)
    names = [r["embedding_name"] for r in saved]
    want = ["ProtGramDirectGCN", "ProtGramDirectGCN_PCA", "Word2Vec", "Word2Vec_PCA",
            "Transformer"]
    if names != want or not _finite([r["test_auc"] for r in saved]):
        fail(f"ppi: sets {names}, AUCs {[r.get('test_auc') for r in saved]}")
    with open(os.path.join(eval_dir, "evaluation_summary.txt")) as fh:
        summary = fh.read().splitlines()
    rows = [ln for ln in summary if "| p=" in ln]
    if sorted(ln.split("|")[0].strip() for ln in rows) != sorted(want[1:]):
        fail(f"ppi: Wilcoxon rows {rows}")
    stats = result["ppi"].stats
    sets = {name: {"test_auc": r["test_auc"], "test_f1": r["test_f1"],
                   "seconds": stats[name]["seconds"], "steps": stats[name]["steps"],
                   "fit_seconds": stats[name]["fit_seconds"],
                   "steps_per_second": stats[name]["steps"] / stats[name]["fit_seconds"]}
            for name, r in zip(names, saved)}
    emit("ppi", seconds=seconds, stage_seconds=result["seconds"], epochs=PPI_EPOCHS,
         sets=sets, wilcoxon_rows=rows,
         transformer_set_seconds=sets["Transformer"]["seconds"])
    return sets


def check_ppi_reference(torch, workdir: str, pca_path: str) -> None:
    """One fold's MLP at the default widths (dropout 0), 3 epochs from the
    same initial parameters on the card and on the CPU, on the main path's
    PCA vectors: the test fold's probabilities within ``PPI_REF_TOL``.  Then
    one skip-gram epoch on a small FASTA on both: the vectors within
    ``W2V_REF_TOL``."""
    from pathlib import Path

    import numpy as np

    from protgram_directgcn_torch.config import Config
    from protgram_directgcn_torch.models.mlp import MLPConfig, MLPTrainer
    from protgram_directgcn_torch.pipeline.splits import stratified_kfold
    from protgram_directgcn_torch.pipeline.word2vec import Word2VecEmbedder
    from protgram_directgcn_torch.utils.embeddings import edge_features
    from protgram_directgcn_torch.utils import profiling
    from protgram_directgcn_torch.utils.io import load_interaction_pairs, read_embeddings

    vectors = read_embeddings(pca_path)
    half = PPI_REF_PAIRS // 2
    pairs = (load_interaction_pairs(os.path.join(workdir, "positive.csv"), 1)[:half]
             + load_interaction_pairs(os.path.join(workdir, "negative.csv"), 0)[:half])
    ids = sorted(vectors)
    row = {pid: i for i, pid in enumerate(ids)}
    table = torch.from_numpy(np.stack([vectors[pid] for pid in ids]).astype(np.float16))
    ia = torch.tensor([row[a] for a, _, _ in pairs])
    ib = torch.tensor([row[b] for _, b, _ in pairs])
    labels = np.array([y for _, _, y in pairs], np.int32)
    tr, te = stratified_kfold(labels, 5, 42)[0]
    counts = np.bincount(labels[tr], minlength=2)
    class_weight = {c: len(tr) / (2.0 * counts[c]) for c in (0, 1)}  # as a PPI fold's
    cfg = MLPConfig(input_dim=2 * table.shape[1], dropout1_rate=0.0, dropout2_rate=0.0)
    probs, seconds, busy = {}, {}, {}
    for dev in (DEVICE, "cpu"):
        t0 = time.monotonic()
        with profiling.profiler(dev) as prof:
            trainer = MLPTrainer(cfg, seed=42, device=dev)
            tab, a, b = table.to(dev), ia.to(dev), ib.to(dev)
            y = torch.from_numpy(labels.astype(np.float32)).to(dev)
            rng = np.random.default_rng(42)

            def batches(order):
                sel_all = torch.from_numpy(order).to(dev)
                for i in range(0, len(order), 1024):
                    sel = sel_all[i : i + 1024]
                    yield edge_features(tab[a[sel]], tab[b[sel]], "concatenate"), y[sel]

            for _ in range(PPI_REF_EPOCHS):
                trainer.fit_epoch(batches(rng.permutation(tr)), class_weight)
            probs[dev] = torch.cat([trainer.predict_proba_tensor(x)
                                    for x, _ in batches(te)]).cpu()
        seconds[dev] = time.monotonic() - t0
        if dev == DEVICE:
            busy["mlp"] = profiling.device_busy(prof, seconds[dev])
    rtol, atol = PPI_REF_TOL
    mlp_err = float((probs[DEVICE] - probs["cpu"]).abs().max())
    if not torch.allclose(probs[DEVICE], probs["cpu"], rtol=rtol, atol=atol):
        fail(f"ppi_reference: MLP probabilities differ by up to {mlp_err}")

    fasta = os.path.join(workdir, "w2v_small.fasta")
    write_fasta(fasta, W2V_REF_SEQS, seed=7, lo=50, hi=400)
    w2v_vecs, w2v_seconds = {}, {}
    for dev in (DEVICE, "cpu"):
        cfg = Config()
        cfg.paths.base_output_dir = Path(workdir) / f"w2v_ref_{dev}"
        cfg.word2vec.epochs = 1
        cfg.word2vec.batch_size = 1024  # tens of steps on the small corpus
        cfg.word2vec.apply_pca = False
        t0 = time.monotonic()
        with profiling.profiler(dev) as prof:
            emb = Word2VecEmbedder(cfg, device=dev)
            emb.run(fasta)
            w2v_vecs[dev] = emb.model.vectors()
        w2v_seconds[dev] = time.monotonic() - t0
        if dev == DEVICE:
            busy["skipgram"] = profiling.device_busy(prof, w2v_seconds[dev])
    if emb.model.steps == 0:
        fail("ppi_reference: the skip-gram epoch took no step")
    rtol, atol = W2V_REF_TOL
    w2v_err = float(np.abs(w2v_vecs[DEVICE] - w2v_vecs["cpu"]).max())
    if not np.allclose(w2v_vecs[DEVICE], w2v_vecs["cpu"], rtol=rtol, atol=atol):
        fail(f"ppi_reference: skip-gram vectors differ by up to {w2v_err}")
    emit("ppi_reference", pairs=len(pairs), train=len(tr), test=len(te), epochs=PPI_REF_EPOCHS,
         mlp_max_abs_err=mlp_err, mlp_tol=PPI_REF_TOL, mlp_seconds=seconds,
         w2v_sequences=W2V_REF_SEQS, w2v_steps=emb.model.steps, w2v_max_abs_err=w2v_err,
         w2v_max_abs=float(np.abs(w2v_vecs["cpu"]).max()), w2v_tol=W2V_REF_TOL,
         w2v_seconds=w2v_seconds, device_busy_under_profiler=busy)


# -----------------------------------------------------------------------------
# Phase 4: ell path
# -----------------------------------------------------------------------------


def run_ell_path(torch, ek, fasta: str, workdir: str):
    """``--stages graph,gcn`` with ``gcn.spmm_mode=pallas`` at n = 1..4.
    Returns (ELL launch counts, graph artifact paths)."""
    argv = ["--fasta", fasta, "--out", os.path.join(workdir, "ell_out"),
            "--stages", "graph,gcn",
            "--set", "graph_builder.ngram_max_n=4",
            "--set", "gcn.spmm_mode=pallas",
            "--set", "gcn.use_cluster_training=false",
            "--set", "gcn.default_task_type=closest_aa",
            "--set", "gcn.hidden_layer_dims=[256,128,64]",
            "--set", f"gcn.epochs_per_level={ELL_PATH_EPOCHS}",
            "--set", "gcn.run_sanity_check_ppi=false",
            "--device", DEVICE]
    ek.reset_launches()
    result, seconds = _drive(torch, argv)
    counts = ek.launch_counts()

    stats = result["trainer"].level_stats
    for n in (1, 2, 3, 4):
        if n not in stats:
            fail(f"ell path: level n={n} did not train")
        st = stats[n]
        if st["route"] != "ell":
            fail(f"ell path: level n={n} took the {st['route']} route, not ell")
        if not _finite(st["losses"]):
            fail(f"ell path: level n={n} has non-finite losses {st['losses']}")
        kernel, other = ("ell_resident", "ell_hbm") if n <= 3 else ("ell_hbm", "ell_resident")
        for direction in ("fwd", "bwd"):
            if st["launches"][kernel][direction] <= 0:
                fail(f"ell path: level n={n}: {kernel} {direction} was never launched")
            if st["launches"][other][direction] != 0:
                fail(f"ell path: level n={n} launched {other} ({direction})")
        check_optimizer_routes(f"ell path n={n}", st)
        check_epilogue_route(f"ell path n={n}", st)
        emit("ell_path_level", level=n, **st)
    if ek.resident_supported(stats[4]["nodes"]):
        fail(f"ell path: the n = 4 level's {stats[4]['nodes']} nodes are in the resident regime")
    emit("ell_path", seconds=seconds, launches=counts,
         launches_by_v=ek.launch_counts_by_v(),
         graph_etl_seconds=_native_etl(result, "ell path"),
         level4_nodes=stats[4]["nodes"],
         level4_step_seconds=stats[4]["train_seconds"] / max(1, stats[4]["epochs"]),
         **_pooled(result, 64))
    return counts, result["graphs"]


# -----------------------------------------------------------------------------
# Phase 5: ell kernels
# -----------------------------------------------------------------------------


def _ell_bound(n_out: int, k: int, n_in: int, f: int):
    """idx and w read once, x once, out written once at the HBM rate; or
    2 * N_out * K * F f32 operations at the f32 rate; the larger."""
    nbytes = n_out * k * 8 + n_in * f * 4 + n_out * f * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * n_out * k * f / PEAK_OPS_PER_S["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _ell_err(got, ref, src, k: int):
    """Max abs error, and whether every element is within rtol 1e-5 and
    atol 1e-6 * max|input| * K (f32 sums of K products, fmaf on the card)."""
    err = (got - ref).abs()
    atol = 1e-6 * float(src.abs().max()) * k
    return float(err.max()), bool((err <= atol + 1e-5 * ref.abs()).all())


def _csr(torch, idx, w, n_in: int):
    """The ELL operator (idx, w) as a CSR tensor (the stored slots with w != 0)."""
    n_out, k = idx.shape
    rows = torch.arange(n_out, device=idx.device).repeat_interleave(k)
    keep = w.reshape(-1) != 0
    ind = torch.stack([rows[keep], idx.reshape(-1).long()[keep]])
    coo = torch.sparse_coo_tensor(ind, w.reshape(-1)[keep], (n_out, n_in))
    return coo.coalesce().to_sparse_csr()


def _ell_timed(torch, ek, name, idx, w, x, iters: int, plain: bool = True) -> dict:
    """Device times of the kernel, its plain version and one torch.sparse.mm
    on a CSR copy; the bound; the gathered rows' bytes and the rate they
    imply (N_out * K * F * 4 bytes: what the kernel reads from L1/L2)."""
    n_out, k = idx.shape
    n_in, f = x.shape
    kernel = getattr(ek, name)
    csr = _csr(torch, idx, w, n_in)
    rec = {"ms": _device_ms(torch, lambda: kernel(idx, w, x), iters),
           "plain_ms": (_device_ms(torch, lambda: ek.ell_plain(idx, w, x), iters)
                        if plain else None),
           "library_ms": _device_ms(torch, lambda: torch.sparse.mm(csr, x), iters)}
    rec["bound_ms"], rec["bound_by"] = _ell_bound(n_out, k, n_in, f)
    rec["gathered_bytes"] = n_out * k * f * 4
    rec["gathered_tb_per_s"] = rec["gathered_bytes"] / (rec["ms"] * 1e-3) / 1e12
    return rec


def _expect_v(torch, ek, name: str, want: dict, what: str) -> dict:
    """Fail unless the launches since the last reset took the variants
    ``want`` ({v: launches}, v the features a thread owns); return them."""
    got = ek.launch_counts_by_v()[name]
    if got != want:
        fail(f"{what}: {name} launched {got} by features a thread, expected {want}")
    return {str(v): n for v, n in got.items()}


def _ell_operator(torch, graph, matrix: str):
    from protgram_directgcn_torch.graph import transforms
    from protgram_directgcn_torch.ops import spmm

    src, tgt, val = transforms.csr_to_coo_arrays(getattr(graph, matrix)())
    return spmm.build_ell(src, tgt, val, graph.num_nodes, device=DEVICE), len(src)


def _check_ell_both_ways(torch, ek, name, adj, x, cot, what: str, want_v: int = 4) -> dict:
    """The kernel direct, and ``propagate`` forward and backward through
    autograd, against the plain versions; three launches of ``name``, each
    with ``want_v`` features a thread."""
    from protgram_directgcn_torch.ops import spmm

    k, k_t = adj.idx.shape[1], adj.idx_t.shape[1]
    ek.reset_launches()
    out = getattr(ek, name)(adj.idx, adj.w, x)
    xg = x.clone().requires_grad_(True)
    y = spmm.propagate(adj, xg)
    y.backward(cot)
    torch.cuda.synchronize()
    rec = {"launches_by_v": _expect_v(torch, ek, name, {want_v: 3}, what)}
    ref = ek.ell_plain(adj.idx, adj.w, x)
    for tag, got, want, inp, kk in (
            ("fwd", out, ref, x, k), ("autograd_fwd", y.detach(), ref, x, k),
            ("bwd", xg.grad, ek.ell_plain(adj.idx_t, adj.w_t, cot), cot, k_t)):
        err, ok = _ell_err(got, want, inp, kk)
        rec[f"{tag}_max_abs_err"] = err
        if not ok or not bool(torch.isfinite(got).all()):
            fail(f"{name} {tag} disagrees with its plain version at {what}: max abs err {err}")
    return rec


def check_ell_kernels(torch, ek, graph_paths):
    """``ell_resident`` at the n = 3 operator and ``ell_hbm`` at the n = 4
    one (𝒜_in as the ell path builds it), F = 32, 64, 128, 256, forward and the
    transpose backward through autograd, against the plain versions, timed
    (the transpose orientation too at F = 256); 𝒜_out and the undirected
    operator at n = 4, F = 256.  Returns the records."""
    from protgram_directgcn_torch.graph.structure import load_graph

    records = []
    for level, name in ((3, "ell_resident"), (4, "ell_hbm")):
        graph = load_graph(graph_paths[level - 1])
        matrices = ("mathcal_a_in",) + (("mathcal_a_out", "undirected_norm") if level == 4 else ())
        for matrix in matrices:
            adj, nnz = _ell_operator(torch, graph, matrix)
            n_out, k = adj.idx.shape
            n_in, k_t = adj.idx_t.shape
            if ek.resident_supported(n_in) != (name == "ell_resident"):
                fail(f"n={level}: {n_in} source nodes are outside the {name} regime")
            iters = 20 if level == 4 else 200
            for f in (ELL_WIDTHS if matrix == "mathcal_a_in" else (max(ELL_WIDTHS),)):
                gen = torch.Generator(device=DEVICE).manual_seed(level * 1000 + f)
                x = torch.randn(n_in, f, device=DEVICE, generator=gen)
                cot = torch.randn(n_out, f, device=DEVICE, generator=gen)
                what = f"n={level} {matrix} F={f}"
                rec = {"name": name, "level": level, "matrix": matrix, "n_out": n_out, "k": k,
                       "n_in": n_in, "k_t": k_t, "nnz": nnz, "f": f, "dtype": "float32",
                       **_check_ell_both_ways(torch, ek, name, adj, x, cot, what),
                       **_ell_timed(torch, ek, name, adj.idx, adj.w, x, iters)}
                rec["wrapper_ms"] = _wrapper_ms(torch, lambda: getattr(ek, name)(
                    adj.idx, adj.w, x), iters)
                if f == max(ELL_WIDTHS):
                    rec["transpose"] = _ell_timed(torch, ek, name, adj.idx_t, adj.w_t, cot,
                                                  iters, plain=False)
                emit("ell_kernels", **rec)
                records.append(rec)
                del x, cot
            del adj
            torch.cuda.empty_cache()
    return records


def _random_ell(torch, seed: int, n_out: int, n_in: int, k: int, pad_rows=()):
    """A seeded ELL with uniform random sources (no row locality) and
    weights; ``pad_rows`` are all padding (w == 0, idx == 0)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    idx = torch.randint(0, n_in, (n_out, k), device=DEVICE, generator=gen, dtype=torch.int32)
    w = torch.rand(n_out, k, device=DEVICE, generator=gen) + 0.1
    for r in pad_rows:
        idx[r] = 0
        w[r] = 0.0
    return idx, w


def check_ell_edges(torch, ek, graph_paths):
    """The cases the kernel body must hold beyond the paths' shapes, each
    against its plain version and its launch variant checked: a ragged F,
    x one element past an aligned start, K past one staging pass with N_out
    not a multiple of a block's rows, rows of padding only, and a random
    ELL with no row locality at the n = 4 size (timed)."""
    from protgram_directgcn_torch.graph.structure import load_graph

    graph = load_graph(graph_paths[2])
    adj, _ = _ell_operator(torch, graph, "mathcal_a_in")
    n3 = graph.num_nodes
    n4 = load_graph(graph_paths[3]).num_nodes
    gen = torch.Generator(device=DEVICE).manual_seed(77)
    base = torch.randn(n3 * 256 + 1, device=DEVICE, generator=gen)
    cases = [  # (case, kernel, idx, w, x, features a thread expected)
        ("ragged_f37", "ell_resident", adj.idx, adj.w,
         torch.randn(n3, 37, device=DEVICE, generator=gen), 1),
        ("misaligned_x", "ell_resident", adj.idx, adj.w, base[1:].view(n3, 256), 1),
    ]
    idx, w = _random_ell(torch, 5, 1003, 5000, 150)  # two staging passes of slots
    cases.append(("k150_rows1003", "ell_resident", idx, w,
                  torch.randn(5000, 256, device=DEVICE, generator=gen), 4))
    idx, w = _random_ell(torch, 6, 999, 3000, 44, pad_rows=(0, 5, 998))
    cases.append(("padding_rows", "ell_resident", idx, w,
                  torch.randn(3000, 256, device=DEVICE, generator=gen), 4))
    idx, w = _random_ell(torch, 7, n4, n4, 44)
    cases.append(("random_n4", "ell_hbm", idx, w,
                  torch.randn(n4, 256, device=DEVICE, generator=gen), 4))
    records = []
    for case, name, idx, w, x, v in cases:
        n_out, k = idx.shape
        plan = ek.launch_plan(n_out, k, x.shape[1], v == 4, x.shape[0])
        ek.reset_launches()
        got = getattr(ek, name)(idx, w, x)
        torch.cuda.synchronize()
        rec = {"case": case, "name": name, "n_out": n_out, "k": k, "n_in": x.shape[0],
               "f": x.shape[1], "plan": plan._asdict(),
               "launches_by_v": _expect_v(torch, ek, name, {v: 1}, case)}
        rec["max_abs_err"], ok = _ell_err(got, ek.ell_plain(idx, w, x), x, k)
        if not ok or not bool(torch.isfinite(got).all()):
            fail(f"{name} disagrees with its plain version on {case}: "
                 f"max abs err {rec['max_abs_err']}")
        if case == "random_n4":
            rec.update(_ell_timed(torch, ek, name, idx, w, x, 20))
        emit("ell_edges", **rec)
        records.append(rec)
    del base, cases, adj
    torch.cuda.empty_cache()
    return records


def check_ell_routing(torch, ek, graph_paths):
    """``spmm.propagate`` on a CUDA ``EllAdj`` (the n = 3 𝒜_in) and a CUDA
    ``BucketedEllAdj`` (the n = 4 𝒜_in), the formats ``gcn.spmm_mode``
    "ell" and "bucketed" build, launches the kernel of its regime forward
    and backward, never the plain version, and agrees with the plain
    version."""
    from protgram_directgcn_torch.graph import transforms
    from protgram_directgcn_torch.graph.structure import load_graph
    from protgram_directgcn_torch.ops import spmm

    result = {}
    for level, builder, name in ((3, spmm.build_ell, "ell_resident"),
                                 (4, spmm.build_bucketed_ell, "ell_hbm")):
        graph = load_graph(graph_paths[level - 1])
        src, tgt, val = transforms.csr_to_coo_arrays(graph.mathcal_a_in())
        adj = builder(src, tgt, val, graph.num_nodes, device=DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(level)
        x = torch.randn(graph.num_nodes, 64, device=DEVICE, generator=gen)
        cot = torch.randn(graph.num_nodes, 64, device=DEVICE, generator=gen)
        plain_calls = []
        real_plain = ek.ell_plain
        ek.ell_plain = lambda *a: plain_calls.append(1) or real_plain(*a)
        ek.reset_launches()
        try:
            xg = x.clone().requires_grad_(True)
            y = spmm.propagate(adj, xg)
            y.backward(cot)
            torch.cuda.synchronize()
        finally:
            ek.ell_plain = real_plain
        counts = ek.launch_counts()
        buckets = (1, 1) if builder is spmm.build_ell else (len(adj.idx), len(adj.idx_t))
        want = {name: {"fwd": buckets[0], "bwd": buckets[1]}}
        if plain_calls or {name: counts[name]} != want or any(
                sum(c.values()) for kname, c in counts.items() if kname != name):
            fail(f"routing: {type(adj).__name__} at n={level} launched {counts} and the plain "
                 f"version {len(plain_calls)} times, expected {want} and none")
        if isinstance(adj, spmm.EllAdj):
            ref, ref_t = (ek.ell_plain(adj.idx, adj.w, x), ek.ell_plain(adj.idx_t, adj.w_t, cot))
        else:
            ref = spmm._bucketed_apply(adj.idx, adj.w, adj.inv_perm, x)
            ref_t = spmm._bucketed_apply(adj.idx_t, adj.w_t, adj.inv_perm_t, cot)
        k = max(int(i.shape[1]) for i in (adj.idx if isinstance(adj.idx, tuple) else (adj.idx,)))
        k_t = max(int(i.shape[1]) for i in (adj.idx_t if isinstance(adj.idx_t, tuple)
                                            else (adj.idx_t,)))
        rec = {"format": type(adj).__name__, "launches": counts[name]}
        for tag, got, want_t, inp, kk in (("fwd", y.detach(), ref, x, k),
                                          ("bwd", xg.grad, ref_t, cot, k_t)):
            err, ok = _ell_err(got, want_t, inp, kk)
            rec[f"{tag}_max_abs_err"] = err
            if not ok:
                fail(f"routing: {type(adj).__name__} at n={level} {tag} disagrees with the "
                     f"plain version: max abs err {err}")
        result[level] = rec
        del adj, x, cot, xg, y
    emit("ell_routing", **{f"n{n}": r for n, r in result.items()})
    return result


# -----------------------------------------------------------------------------
# Phases 3 and 6: reference on a small input
# -----------------------------------------------------------------------------


def check_reference(torch, ek, workdir: str, mode: str):
    """Forward and gradients of the model on the card against the port's
    CPU path, on a small n = 3 graph with ``mode`` operators ("hypercube";
    or "ell" through the ELL kernels) (rtol 1e-4, atol 1e-5 * max|leaf|:
    float32 with TF32 off, summed in another order)."""
    import numpy as np

    from protgram_directgcn_torch.graph.builder import NgramGraphBuilder
    from protgram_directgcn_torch.models import directgcn
    from protgram_directgcn_torch.utils.io import parse_fasta

    fasta = os.path.join(workdir, "small.fasta")
    write_fasta(fasta, 300, seed=7, lo=20, hi=200)
    graph = NgramGraphBuilder(n_max=3).build_from_sequences(list(parse_fasta(fasta)))[2]
    outs = {}
    from protgram_directgcn_torch import convert

    params_cpu = None
    ek.reset_launches()
    for dev in (DEVICE, "cpu"):
        dg = graph.to_device(mode=mode, device=dev)
        cfg = directgcn.DirectGCNConfig(layer_dims=(32, 64, 32, 16), num_nodes=dg.num_nodes,
                                        num_classes=40, n_gram_len=3, dropout=0.0,
                                        decoder_dropout=0.0)
        if params_cpu is None:
            params_cpu = directgcn.init_directgcn_params(torch.Generator().manual_seed(3), cfg,
                                                         "cpu")
        params = convert.params_from_jax(convert.params_to_numpy(params_cpu), dev)
        for p in directgcn.param_leaves(params):
            p.requires_grad_(True)
        rng = np.random.default_rng(5)
        x = torch.from_numpy(rng.normal(size=(dg.num_nodes, 32)).astype(np.float32)).to(dev)
        r = torch.from_numpy(rng.normal(size=(dg.num_nodes, 40)).astype(np.float32)).to(dev)
        ls, emb = directgcn.directgcn_apply(params, dg, x, cfg, train=True)
        (torch.sum(ls * r) + torch.sum(emb)).backward()
        outs[dev] = [ls.detach().cpu(), emb.detach().cpu()] + [p.grad.cpu() for p in
                                                                 directgcn.param_leaves(params)]
    counts = ek.launch_counts()
    if mode == "ell" and not (counts["ell_resident"]["fwd"] and counts["ell_resident"]["bwd"]):
        fail(f"ell reference: the ELL kernels did not run on the card ({counts})")
    worst = 0.0
    for got, ref in zip(outs[DEVICE], outs["cpu"]):
        if not bool(torch.isfinite(got).all()):
            fail(f"{mode} reference: non-finite model output or gradient on the card")
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        err = (got - ref).abs()
        if not bool((err <= tol + 1e-4 * ref.abs()).all()):
            fail(f"{mode} reference: card and CPU disagree: max abs err {float(err.max())}")
        worst = max(worst, float(err.max()))
    emit("reference" if mode == "hypercube" else "ell_reference", nodes=graph.num_nodes,
         device_nodes=int(outs["cpu"][0].shape[0]), tensors_compared=len(outs["cpu"]),
         max_abs_err=worst, ell_launches=counts)


# -----------------------------------------------------------------------------
# Phases 7-9: cluster path, Louvain and the cluster reference
# -----------------------------------------------------------------------------


def run_cluster_path(torch, ek, fasta: str, workdir: str):
    """``--stages graph,gcn`` at n = 1..4 with ``gcn.spmm_mode=pallas`` and
    every other knob at its default but the epochs and the PPI check:
    n <= 3 full batch through ``ell_resident``; n = 4 (above the cluster
    threshold, off the hypercube) on Louvain labels and Cluster-GCN batches,
    its eval pass through ``ell_hbm``; the pooled embeddings written with
    their PCA.  Returns (ELL launch counts, graph paths, the n = 4 level's
    stats)."""
    import numpy as np

    from protgram_directgcn_torch.config import GCNConfig
    from protgram_directgcn_torch.utils.io import read_embeddings

    argv = ["--fasta", fasta, "--out", os.path.join(workdir, "cluster_out"),
            "--stages", "graph,gcn",
            "--set", "graph_builder.ngram_max_n=4",
            "--set", "gcn.spmm_mode=pallas",
            "--set", "gcn.hidden_layer_dims=[256,128,64]",
            "--set", f"gcn.epochs_per_level={CLUSTER_PATH_EPOCHS}",
            "--set", "gcn.run_sanity_check_ppi=false",
            "--device", DEVICE]
    ek.reset_launches()
    result, seconds = _drive(torch, argv)
    counts = ek.launch_counts()

    defaults = GCNConfig()
    stats = result["trainer"].level_stats
    for n in (1, 2, 3, 4):
        if n not in stats:
            fail(f"cluster path: level n={n} did not train")
        st = stats[n]
        if not _finite(st["losses"]):
            fail(f"cluster path: level n={n} has non-finite losses {st['losses']}")
        check_optimizer_routes(f"cluster path n={n}", st)
        check_epilogue_route(f"cluster path n={n}", st)
        emit("cluster_path_level", level=n, **st)
    for n in (1, 2, 3):
        st = stats[n]
        if st["route"] != "ell" or st["task"] != "next_node":
            fail(f"cluster path: level n={n} took {st['route']} / {st['task']}, not ell full "
                 "batch on next_node")
        for direction in ("fwd", "bwd"):
            if st["launches"]["ell_resident"][direction] <= 0:
                fail(f"cluster path: level n={n}: ell_resident {direction} was never launched")
    st = stats[4]
    want_clusters = min(defaults.max_clusters, max(defaults.min_clusters, -(
        -st["nodes"] // defaults.target_nodes_per_cluster)))
    got = (st["route"], st["block_format"], st["resident"], st["clusters"])
    if got != ("cluster", "dense", True, want_clusters) or (
            st["budget"] > defaults.cluster_dense_max_budget):
        fail(f"cluster path: n = 4 took route {st['route']}, {st['clusters']} {st['block_format']} "
             f"batches of budget {st['budget']}, resident {st['resident']}; expected "
             f"{want_clusters} dense resident batches of budget <= "
             f"{defaults.cluster_dense_max_budget}")
    if st["task"] != "community" or st["num_classes"] <= 1:
        fail(f"cluster path: n = 4 task {st['task']} with {st['num_classes']} classes")
    if st["eval_launches"]["ell_hbm"]["fwd"] <= 0 or ek.resident_supported(st["nodes"]):
        fail(f"cluster path: the n = 4 eval pass did not run ell_hbm ({st['eval_launches']})")
    path = result["embeddings_path"]
    pca = read_embeddings(path)
    vecs = np.stack(list(pca.values()))
    n_pooled = len(result["pooled"])
    if (not path.rsplit("/", 1)[1].startswith(f"gcn_n4_embeddings_pca{defaults.pca_target_dim}.")
            or len(pca) != n_pooled or vecs.shape != (n_pooled, defaults.pca_target_dim)
            or vecs.dtype != np.float16 or not np.isfinite(vecs).all()):
        fail(f"cluster path: PCA file {path}: {len(pca)} proteins of {n_pooled}, shape "
             f"{vecs.shape}, {vecs.dtype}")
    emit("cluster_path", seconds=seconds, launches=counts, level4_nodes=st["nodes"],
         graph_etl_seconds=_native_etl(result, "cluster path"),
         level4_clusters=st["clusters"], level4_budget=st["budget"],
         level4_classes=st["num_classes"], louvain_seconds=st["louvain_seconds"],
         cluster_build_seconds=st["cluster_build_seconds"],
         level4_operator_seconds=st["operator_seconds"],
         level4_steps=st["steps"], level4_step_seconds=st["train_seconds"] / st["steps"],
         pca_file=path.rsplit("/", 1)[1], pca_shape=list(vecs.shape),
         **_pooled(result, TIER_DIMS[-1]))
    return counts, result["graphs"], st


def check_louvain(graph_paths, level4_louvain_seconds: float):
    """The C++ Louvain sweep against the numpy one on the n = 3 graph's
    community adjacency (A_out + A_outᵀ, as ``community_labels`` builds
    it): byte-equal labels; both times."""
    import numpy as np
    import scipy.sparse as sp

    from protgram_directgcn_torch.graph import community
    from protgram_directgcn_torch.graph.structure import load_graph

    graph = load_graph(graph_paths[2])
    n = graph.num_nodes
    a = sp.coo_matrix((graph.weight, (graph.src, graph.tgt)), shape=(n, n)).tocsr()
    adj = a + a.T
    times, labels = {}, {}
    for name, sweep in (("native", None), ("plain", community.sweep_plain)):
        t0 = time.monotonic()
        labels[name] = community.louvain_communities(adj, seed=42, sweep=sweep)
        times[name] = time.monotonic() - t0
    same = (labels["native"].dtype == labels["plain"].dtype
            and labels["native"].tobytes() == labels["plain"].tobytes())
    if not same:
        fail("louvain: the C++ sweep's labels differ from the numpy sweep's on the n = 3 graph")
    emit("louvain", level=3, nodes=n, edges=int(adj.nnz),
         communities=int(labels["native"].max()) + 1, byte_equal=same,
         native_seconds=times["native"], plain_seconds=times["plain"],
         build=community.BUILD_INFO, level4_louvain_seconds=level4_louvain_seconds)


def check_cluster_reference(torch, ek, graph_path: str, classes: int):
    """One train step's loss and every parameter gradient on the card
    against the same step on the CPU, from the same parameters, on three
    n = 4 Cluster-GCN batches of each block format: dense (the default
    ``cluster_dense_max_budget``) and padded ELL (the cap below the budget;
    ``ell_resident`` on the card).  Dropout 0, TF32 off, rtol 1e-4 and atol
    1e-5 x max|leaf| (``check_reference``'s tolerance)."""
    import numpy as np

    from protgram_directgcn_torch.config import Config
    from protgram_directgcn_torch.graph.structure import load_graph
    from protgram_directgcn_torch.models import directgcn
    from protgram_directgcn_torch.pipeline.trainer import HierarchicalTrainer, _primary_loss

    graph = load_graph(graph_path)
    n = graph.num_nodes
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n, TIER_DIMS[-1])).astype(np.float32)
    y = rng.integers(0, classes, n)
    dims = (TIER_DIMS[-1],) + tuple(TIER_DIMS)
    cfg = directgcn.DirectGCNConfig(layer_dims=dims, num_nodes=n, num_classes=classes,
                                    n_gram_len=4, dropout=0.0, decoder_dropout=0.0)
    params_cpu = directgcn.init_directgcn_params(torch.Generator().manual_seed(4), cfg, "cpu")
    result = {}
    for fmt, cap in (("dense", Config().gcn.cluster_dense_max_budget), ("ell", 0)):
        config = Config()
        config.gcn.cluster_dense_max_budget = cap
        t0 = time.monotonic()
        batches, _ = HierarchicalTrainer(config, device="cpu")._make_cluster_batches(
            graph, x, y, config.random_state)
        build_seconds = time.monotonic() - t0
        if (type(batches[0].graph.p_in).__name__ == "DenseAdj") != (fmt == "dense"):
            fail(f"cluster reference: the {fmt} cap built {type(batches[0].graph.p_in).__name__}")
        ek.reset_launches()
        worst, compared = 0.0, 0
        for bi in (0, len(batches) // 2, len(batches) - 1):
            grads = {}
            for dev in (DEVICE, "cpu"):
                b = batches[bi].to_device(dev)
                params = _tree_to(torch, params_cpu, dev)
                for p in directgcn.param_leaves(params):
                    p.requires_grad_(True)
                loss = _primary_loss(params, b.graph, b.x, b.y, b.mask, None, cfg,
                                     b.original_indices) * b.weight_factor
                loss.backward()
                grads[dev] = [loss.detach().cpu().reshape(1)] + [
                    p.grad.cpu() for p in directgcn.param_leaves(params)]
                del params, b, loss
            for i, (got, ref) in enumerate(zip(grads[DEVICE], grads["cpu"])):
                if not bool(torch.isfinite(got).all()):
                    fail(f"cluster reference: {fmt} batch {bi} tensor {i} is not finite")
                err = (got - ref).abs()
                if not bool((err <= 1e-5 * max(1.0, float(ref.abs().max()))
                             + 1e-4 * ref.abs()).all()):
                    fail(f"cluster reference: {fmt} batch {bi} tensor {i}: card and CPU "
                         f"disagree, max abs err {float(err.max())}")
                worst = max(worst, float(err.max()))
                compared += 1
            del grads
        counts = ek.launch_counts()
        if fmt == "ell" and not (counts["ell_resident"]["fwd"] and counts["ell_resident"]["bwd"]):
            fail(f"cluster reference: the ELL blocks did not run ell_resident ({counts})")
        result[fmt] = {"clusters": len(batches), "budget": int(batches[0].x.shape[0]),
                       "build_seconds": build_seconds, "tensors_compared": compared,
                       "max_abs_err": worst, "ell_launches": counts}
        del batches
        torch.cuda.empty_cache()
    emit("cluster_reference", level=4, nodes=n, classes=classes, **result)


# -----------------------------------------------------------------------------
# Phase 10: tier reference on a small input
# -----------------------------------------------------------------------------


def _tree_to(torch, tree, dev):
    """A parameter tree copied to ``dev``, each leaf keeping its type."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_to(torch, v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(torch, v, dev) for v in tree]
    return tree.detach().clone().to(dev)


def check_tier_reference(torch, rt, workdir: str):
    """The model's outputs and gradients at tiers 1-3 on the card against
    the port's CPU path (which tests/test_torch_tiers.py holds against the
    JAX package), on the small n = 3 hypercube graph of phase 3.  Tier 1
    (float32): rtol 1e-4, atol 1e-5 * max|leaf| (phase 3's tolerance).
    Tiers 2-3 (bf16): outputs within 5% of max|ref|; each gradient leaf
    finite, of its parameter's type and within 25% of the reference's norm
    (the CPU tests' bf16 rule), with the objective on the real nodes."""
    import numpy as np

    from protgram_directgcn_torch.graph.builder import NgramGraphBuilder
    from protgram_directgcn_torch.models import directgcn
    from protgram_directgcn_torch.pipeline.trainer import TIER_LEVERS, _node_params_to_rg
    from protgram_directgcn_torch.utils.io import parse_fasta

    fasta = os.path.join(workdir, "small_tiers.fasta")
    write_fasta(fasta, 300, seed=7, lo=20, hi=200)
    graph = NgramGraphBuilder(n_max=3).build_from_sequences(list(parse_fasta(fasta)))[2]
    result = {}
    for tier in (1, 2, 3):
        cd, nd, rm, _, rp = TIER_LEVERS[tier]
        rt.reset_launches()
        dtype = getattr(torch, cd)
        outs, params_cpu = {}, None
        for dev in (DEVICE, "cpu"):
            dg = graph.to_device(mode="hypercube", dtype=dtype, device=dev)
            cfg = directgcn.DirectGCNConfig(
                layer_dims=(32, 64, 32, 16), num_nodes=dg.num_nodes, num_classes=40,
                n_gram_len=3, dropout=0.0, decoder_dropout=0.0, compute_dtype=cd,
                node_param_dtype=nd, remat=rm, remat_paths=rp)
            if params_cpu is None:
                params_cpu = _node_params_to_rg(directgcn.init_directgcn_params(
                    torch.Generator().manual_seed(3), cfg, "cpu"), dg)
            params = _tree_to(torch, params_cpu, dev)
            for p in directgcn.param_leaves(params):
                p.requires_grad_(True)
            rng = np.random.default_rng(5)
            real = np.zeros((dg.num_nodes, 1), np.float32)
            real[dg.node_map.cpu().numpy()] = 1.0
            x = torch.from_numpy(rng.normal(size=(dg.num_nodes, 32)).astype(np.float32)).to(dev)
            r = torch.from_numpy(rng.normal(size=(dg.num_nodes, 40)).astype(np.float32)
                                 * real).to(dev)
            r_emb = torch.from_numpy(rng.normal(size=(dg.num_nodes, 16)).astype(np.float32)
                                     * real).to(dev)
            ls, emb = directgcn.directgcn_apply(params, dg, x, cfg, train=True)
            (torch.sum(ls.float() * r) + torch.sum(emb * r_emb)).backward()
            outs[dev] = [ls.detach().cpu(), emb.detach().cpu()] + [
                p.grad.cpu() for p in directgcn.param_leaves(params)]
        counts = rt.launch_counts()
        if rp and not all(counts[k][d] for k in counts for d in ("fwd", "bwd")):
            fail(f"tier reference: tier {tier} did not run pack and unpack on the card ({counts})")
        worst = 0.0
        for i, (got, ref) in enumerate(zip(outs[DEVICE], outs["cpu"])):
            if got.dtype != ref.dtype or not bool(torch.isfinite(got.float()).all()):
                fail(f"tier reference: tier {tier} tensor {i}: {got.dtype} on the card, "
                     f"{ref.dtype} on the CPU, or not finite")
            got, ref = got.float(), ref.float()
            err = (got - ref).abs()
            if cd == "float32":
                ok = bool((err <= 1e-5 * max(1.0, float(ref.abs().max())) + 1e-4 * ref.abs()).all())
                rel = float(err.max())
            elif i < 2:
                rel = float(err.max()) / max(float(ref.abs().max()), 1e-30)
                ok = rel <= BF16_REL_TO_MAX
            else:
                rel = float(torch.linalg.vector_norm(got - ref)) / max(
                    float(torch.linalg.vector_norm(ref)), 1e-30)
                ok = rel <= BF16_GRAD_NORM_REL
            if not ok:
                fail(f"tier reference: tier {tier} tensor {i}: card and CPU disagree ({rel})")
            worst = max(worst, rel)
        result[tier] = {"compute": cd, "node_params": nd, "remat": rm, "remat_paths": rp,
                        "tensors_compared": len(outs["cpu"]), "worst": worst,
                        "retile_launches": counts}
    emit("tier_reference", nodes=graph.num_nodes, device_nodes=int(outs["cpu"][0].shape[0]),
         worst_is="tier 1: max abs err; tiers 2-3: the larger of the outputs' max err / "
                  "max|ref| and the gradients' norm of err / norm of ref",
         tiers=result)


# -----------------------------------------------------------------------------
# Phase 11: retile kernels
# -----------------------------------------------------------------------------


def _retile_bound(kind: str, a: int, gp: int, f: int, itemsize: int):
    """Bytes only (a copy does no arithmetic).  unpack reads the packed
    [A, GP, 128] and writes [A, GP*k, 128]; pack needs the f lanes of each
    of the A*GP*k input rows, whatever the input's row width, and writes
    [A, GP, 128]."""
    k = 128 // f
    if kind == "unpack":
        nbytes = (a * gp * 128 + a * gp * k * 128) * itemsize
    else:
        nbytes = (a * gp * k * f + a * gp * 128) * itemsize
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def check_retile_kernels(torch, rt):
    """Pack and unpack at the 5-gram tier-3 carry, held bit for bit against
    their plain versions (forward, and the autograd backward through the
    other kernel), and timed."""
    import torch.nn.functional as F

    a, g, f = RETILE_CARRY
    k = 128 // f
    g8 = -(-g // k) * k
    gp = g8 // k
    records = []
    for dt in ("bfloat16", "float32"):
        tdt = getattr(torch, dt)
        gen = torch.Generator(device=DEVICE).manual_seed(55)

        def rand(*shape):
            return torch.randn(*shape, device=DEVICE, generator=gen).to(tdt)

        packed, exact, padded = rand(a, gp, 128), rand(a, g8, f), rand(a, g8, 128)
        cot_u, cot_p = rand(a, g8, 128), rand(a, gp, 128)
        checks = {
            "unpack": (rt.unpack(packed, f), rt.unpack_plain(packed, f)),
            "pack_exact": (rt.pack(exact, f), rt.pack_plain(exact, f)),
            "pack_padded": (rt.pack(padded, f), rt.pack_plain(padded, f)),
        }
        xu = packed.clone().requires_grad_(True)
        yu = rt.unpack_pad_rg(xu, f)
        yu.backward(cot_u)
        checks["unpack_autograd_fwd"] = (yu.detach(), checks["unpack"][1])
        checks["unpack_autograd_bwd"] = (xu.grad, rt.pack_plain(cot_u, f))
        for form, src in (("exact", exact), ("padded", padded)):
            xp = src.clone().requires_grad_(True)
            yp = rt.pack_rg(xp, f)
            yp.backward(cot_p)
            checks[f"pack_{form}_autograd_fwd"] = (yp.detach(), checks[f"pack_{form}"][1])
            checks[f"pack_{form}_autograd_bwd"] = (
                xp.grad, rt.unpack_plain(cot_p, f)[..., :src.shape[-1]])
        torch.cuda.synchronize()
        rec = {"carry": [a, g, f], "g_padded": g8, "packed_rows": gp, "dtype": dt}
        for name, (got, ref) in checks.items():
            rec[f"{name}_max_abs_err"] = float((got.float() - ref.float()).abs().max())
            if got.shape != ref.shape or not bool(torch.equal(got, ref)):
                fail(f"retile {name} differs from its plain version ({dt}, "
                     f"max abs err {rec[f'{name}_max_abs_err']})")
        del checks, xu, yu, xp, yp
        iters = 20
        fns = {
            "unpack": lambda: rt.unpack(packed, f),
            "unpack_plain": lambda: rt.unpack_plain(packed, f),
            "unpack_library": lambda: F.pad(packed.view(a, g8, f), (0, 128 - f)),
            "pack_padded": lambda: rt.pack(padded, f),
            "pack_padded_plain": lambda: rt.pack_plain(padded, f),
            "pack_padded_library": lambda: padded[..., :f].reshape(a, gp, 128),
            "pack_exact": lambda: rt.pack(exact, f),
            "pack_exact_plain": lambda: rt.pack_plain(exact, f),
        }
        for key, fn in fns.items():
            rec[f"{key}_ms"] = _device_ms(torch, fn, iters)
        for key in ("unpack", "pack_padded", "pack_exact"):
            rec[f"{key}_wrapper_ms"] = _wrapper_ms(torch, fns[key], iters)
            rec[f"{key}_bound_ms"], rec[f"{key}_bound_by"] = _retile_bound(
                key.split("_")[0], a, gp, f, packed.element_size())
        if not torch.equal(exact.view(a, gp, 128), rt.pack(exact, f)):
            fail("retile: the exact-width pack is not the reshape view of its input")
        emit("retile_kernels", **rec)
        records.append(rec)
        del packed, exact, padded, cot_u, cot_p, fns
        torch.cuda.empty_cache()
    return records


def check_optim_kernels(torch, ok):
    """Adam and the sum of squares (``csrc/optim.cu``) over each of
    ``OPTIM_CASES``' leaves: the benchmark cells' n = 4 level (58 f32
    leaves over the hypercube's rows or the vocabulary) and the tier path's
    5-gram level at tier 2 (bf16 node tables, f32 weights, in one launch).
    One step of each kernel over every leaf, held against its plain version
    from the same state, leaf by leaf: f32 leaves within rtol 2.5e-7 / atol
    2e-9 and their moments within 2 f32 ulps of the terms each sums; bf16
    leaves within one bf16 ulp of the value (2^-7 of it, plus 1e-2) and
    their moments within 2^-7 of the terms (the card tests' bounds); the
    sum within rtol 1e-6 of the plain sum and of a float64 sum.  Then
    timed: kernel, plain version and wrapper, beside the bound (each
    element's p, g, mu and nu read and p, mu and nu written once; read once
    for the sum)."""
    from protgram_directgcn_torch.models import directgcn
    from protgram_directgcn_torch.models.mlp import adam_bias_corrections
    from protgram_directgcn_torch.pipeline import trainer as tr

    chunk = tr._UPDATE_CHUNK
    b1, b2, c = tr._ADAM_B1, tr._ADAM_B2, 2e-7
    args = (1e-3, b1, b2, tr._ADAM_EPS, *adam_bias_corrections(3), c)
    records = []
    for case, (nodes, n_gram, node_dtype) in OPTIM_CASES.items():
        cfg = directgcn.DirectGCNConfig(layer_dims=OPTIM_DIMS, num_nodes=nodes, num_classes=4,
                                        n_gram_len=n_gram, node_param_dtype=node_dtype)
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        params = directgcn.init_directgcn_params(gen, cfg, DEVICE)
        if nodes == 21**n_gram:  # stored as the trainer stores a hypercube level's constants
            for lp in params["layers"]:
                lp["constant"] = lp["constant"].reshape(21, nodes // 21, -1)
        ps = directgcn.param_leaves(params)
        del params
        for p in ps:
            p.grad = torch.randn(p.shape, device=DEVICE, generator=gen).to(p.dtype)
        mus = [torch.randn(p.shape, device=DEVICE, generator=gen).mul_(1e-2) for p in ps]
        nus = [torch.rand(p.shape, device=DEVICE, generator=gen).mul_(1e-4) for p in ps]
        elements = sum(p.numel() for p in ps)
        bf16 = sum(p.numel() for p in ps if p.dtype == torch.bfloat16)
        # The state before the step; the plain version steps it leaf by leaf.
        ref = [(p.detach().clone(), mu.clone(), nu.clone()) for p, mu, nu in zip(ps, mus, nus)]
        launches = ok.launch_counts()
        l2 = float(ok.sum_squares(ps, chunk))
        ok.adam(ps, mus, nus, *args, chunk)
        launches = {k: v - launches[k] for k, v in ok.launch_counts().items()}
        l2_plain = float(ok.sum_squares_plain([r[0] for r in ref], chunk))
        l2_exact = sum(float(torch.sum(r[0].reshape(-1)[sl].double() ** 2))
                       for r in ref for sl in ok.row_slices(r[0].reshape(-1), chunk))
        worst = {"p": 0.0, "mu": 0.0, "nu": 0.0}
        for i, (p, mu, nu) in enumerate(zip(ps, mus, nus)):
            p0, mu0, nu0 = ref[i]
            half = p.dtype == torch.bfloat16
            ulps = 2.0**-7 if half else 2.0**-22
            flat = [t.detach().reshape(-1) for t in (p0, mu0, nu0, p.grad)]
            # Each moment's room from the terms it sums (b1 * mu and
            # (1 - b1) * g' may cancel; one version fuses a multiply into an add).
            rooms = [torch.empty(p.numel(), device=DEVICE) for _ in range(2)]
            for sl in ok.row_slices(flat[0], chunk):
                g = flat[3][sl].float().abs() + c * flat[0][sl].float().abs()
                torch.mul(b1 * flat[1][sl].abs() + (1 - b1) * g, ulps, out=rooms[0][sl])
                torch.mul(b2 * flat[2][sl] + (1 - b2) * g * g, ulps, out=rooms[1][sl])
            p0.grad = p.grad
            ok.adam_plain([p0], [mu0], [nu0], *args, chunk)
            p0.grad = None
            for sl in ok.row_slices(flat[0], chunk):
                want = flat[0][sl].float()
                room_p = 2.0**-7 * (want.abs() + 1e-2) if half else 2e-9 + 2.5e-7 * want.abs()
                for key, got, w, room in (
                        ("p", p.detach().reshape(-1)[sl].float(), want, room_p),
                        ("mu", mu.reshape(-1)[sl], flat[1][sl], rooms[0][sl]),
                        ("nu", nu.reshape(-1)[sl], flat[2][sl], rooms[1][sl])):
                    err = (got - w).abs()
                    worst[key] = max(worst[key], float(err.max()))
                    if not bool((err <= room + 1e-30).all()):
                        fail(f"optim {case}: adam's {key} of leaf {i} ({p.dtype}, "
                             f"{tuple(p.shape)}) differs from its plain version "
                             f"(max abs err {float(err.max())})")
            del rooms
        rec = {"case": case, "leaves": len(ps), "elements": elements, "bf16_elements": bf16,
               "largest_leaf": max(p.numel() for p in ps), "launches_per_step": launches,
               "l2": l2, "l2_plain": l2_plain, "l2_exact": l2_exact,
               "l2_rel_err": abs(l2 - l2_plain) / l2_plain,
               "l2_rel_err_exact": abs(l2 - l2_exact) / l2_exact,
               "l2_plain_rel_err_exact": abs(l2_plain - l2_exact) / l2_exact,
               "max_abs_err": worst}
        if max(rec["l2_rel_err"], rec["l2_rel_err_exact"]) > 1e-6:
            fail(f"optim {case}: sum of squares {l2} against the plain {l2_plain} and the "
                 f"float64 {l2_exact}")
        del ref
        torch.cuda.empty_cache()
        iters = 10 if not bf16 else 3
        fns = {"adam": lambda: ok.adam(ps, mus, nus, *args, chunk),
               "adam_plain": lambda: ok.adam_plain(ps, mus, nus, *args, chunk),
               "l2": lambda: ok.sum_squares(ps, chunk),
               "l2_plain": lambda: ok.sum_squares_plain(ps, chunk)}
        for key, fn in fns.items():
            rec[f"{key}_ms"] = _device_ms(torch, fn, iters)
        for key in ("adam", "l2"):
            rec[f"{key}_wrapper_ms"] = _wrapper_ms(torch, fns[key], iters)
        # Adam: 28 bytes an f32 element, 22 a bf16 one (p and g 2 bytes); the sum 4 or 2.
        rec["adam_bound_ms"] = (28 * elements - 6 * bf16) / HBM_BYTES_PER_S * 1e3
        rec["l2_bound_ms"] = (4 * elements - 2 * bf16) / HBM_BYTES_PER_S * 1e3
        emit("optim_kernels", **rec)
        records.append(rec)
        del ps, mus, nus, fns
        torch.cuda.empty_cache()
    return records


def _epilogue_case(torch, shape, seed: int):
    """A layer tail's operands at ``shape`` on the card: paths, residual,
    constant (rg like the carry), biases, [N, 1] gates (viewed rg on an rg
    carry) near 1, the dropout's uniforms and an output gradient; the
    leaves require grad."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    f = shape[-1]
    rows = 1
    for d in shape[:-1]:
        rows *= d

    def leaf(sh, scale=1.0, loc=0.0):
        return (loc + scale * torch.randn(sh, generator=gen, device=DEVICE)).requires_grad_(True)

    lv = {k: leaf(shape) for k in ("pi", "po", "pu", "res")}
    lv.update({k: leaf((f,), 0.3) for k in ("b_in", "b_out", "b_und")})
    lv.update({k: leaf((rows, 1), 0.3, 1.0) for k in ("c_in", "c_out", "c_dir", "c_und", "c_all")})
    lv["const"] = leaf(shape, 0.5)
    gates = tuple(lv[k].reshape(shape[:-1] + (1,)) for k in ("c_in", "c_out", "c_dir", "c_und",
                                                              "c_all"))
    u = torch.rand(shape, generator=gen, device=DEVICE)
    dout = torch.randn(shape, generator=gen, device=DEVICE)
    args = (lv["pi"], lv["po"], lv["pu"], lv["b_in"], lv["b_out"], lv["b_und"], gates,
            lv["const"], lv["res"])
    return lv, args, u, dout


def check_epilogue_kernels(torch, epk):
    """The layer tail (``csrc/epilogue.cu``) at ``EPILOGUE_SHAPES``, dropout
    0.5: the op's forward against the plain chain (``tail_plain``) bit for
    bit; its gradients against the chain's under autograd, the paths',
    constant's and residual's bit for bit, the gates' and biases' within
    ``EPILOGUE_SUM_RTOL`` of their largest element; two launches.  Then
    timed: each kernel as the op calls it and the plain chain's forward
    (CUDA graphs), the plain chain's forward and backward and the op's
    through its wrapper (a host loop), beside the bound (each operand read and each output written once: 29
    bytes an element forward, 33 backward)."""
    slope, keep = 0.01, 0.5
    records = []
    for case, shapes in EPILOGUE_SHAPES.items():
        for shape in shapes:
            lv, args, u, dout = _epilogue_case(torch, shape, seed=7)
            names = list(lv)
            launches = epk.launch_counts()["layer_tail"]
            out = epk.layer_tail(*args, slope, keep, u)
            got = torch.autograd.grad(out, [lv[k] for k in names], dout)
            launches = {d: v - launches[d] for d, v in epk.launch_counts()["layer_tail"].items()}
            ref_out = epk.tail_plain(*args, slope, keep, u)
            ref = torch.autograd.grad(ref_out, [lv[k] for k in names], dout)
            torch.cuda.synchronize()
            errs = {k: float((g - r).abs().max()) for k, g, r in zip(names, got, ref)}
            rel = {k: errs[k] / max(float(r.abs().max()), 1e-30) for k, r in zip(names, ref)}
            exact = ("pi", "po", "pu", "res", "const")
            if not torch.equal(out, ref_out):
                fail(f"epilogue {shape}: the forward differs from the plain chain "
                     f"(max abs err {float((out - ref_out).abs().max())})")
            bad = [k for k in names if (errs[k] != 0 if k in exact
                                        else rel[k] > EPILOGUE_SUM_RTOL)]
            if bad or launches != {"fwd": 1, "bwd": 1}:
                fail(f"epilogue {shape}: gradients {bad} past their allowance ({rel}); "
                     f"launches {launches}")
            del out, got, ref_out, ref
            rows = u.numel() // shape[-1]
            flat = [t.detach().reshape(rows, shape[-1]) for t in args[:3]]
            biases = [t.detach() for t in args[3:6]]
            gates = [lv[k].detach().reshape(-1) for k in ("c_in", "c_out", "c_dir", "c_und",
                                                          "c_all")]
            const, res = (lv[k].detach().reshape(rows, shape[-1]) for k in ("const", "res"))
            uf, df = u.reshape(rows, shape[-1]), dout.reshape(rows, shape[-1])
            fwd_args = (*flat, *biases, gates, const, res, slope, keep, uf)
            _, code = epk._forward(*fwd_args, keep_code=True)
            inv = epk.inverse_keep(keep)
            leaves = [lv[k] for k in names]
            fns = {
                "fwd": lambda: epk._forward(*fwd_args, keep_code=True),
                "bwd": lambda: epk._backward(df, code, *flat, *biases, gates, slope, inv),
                "plain_fwd": lambda: epk.tail_plain(*args, slope, keep, u),
            }
            rec = {"case": case, "shape": list(shape), "rows": rows, "f": shape[-1],
                   "launches": launches, "max_abs_err": errs, "rel_err": rel,
                   "plan": epk.launch_plan(shape[-1], True)._asdict()}
            for key, fn in fns.items():
                rec[f"{key}_ms"] = _device_ms(torch, fn, 10)
            # Autograd's backward does not capture into a CUDA graph here (it
            # touches the legacy stream): both ways from a host loop, which
            # the chain's ~50 full passes keep busy.
            for key, tail in (("plain_fwd_bwd", epk.tail_plain), ("wrapper_fwd_bwd",
                                                                   epk.layer_tail)):
                rec[f"{key}_ms"] = _wrapper_ms(torch, lambda t=tail: torch.autograd.grad(
                    t(*args, slope, keep, u), leaves, dout), 10)
            elems = rows * shape[-1]
            rec["bound_fwd_ms"] = 29 * elems / HBM_BYTES_PER_S * 1e3
            rec["bound_bwd_ms"] = 33 * elems / HBM_BYTES_PER_S * 1e3
            rec["bound_ms"] = EPILOGUE_BYTES * elems / HBM_BYTES_PER_S * 1e3
            emit("epilogue_kernels", **rec)
            records.append(rec)
            del lv, args, u, dout, fns, code, leaves, flat, const, res, uf, df, fwd_args
            torch.cuda.empty_cache()
    return records


# -----------------------------------------------------------------------------
# Phase 11b: GAT's attention kernels
# -----------------------------------------------------------------------------

GAT_LAYERS = ((4, 256), (6, 121))  # (heads, width a head): the PPI model's hidden and output layers
# The output's and each gradient's allowance, a share of its largest
# element: sums of ~20 terms in other orders, and d_a_dst a sum whose terms
# mostly cancel (the softmax's derivative sums to 0 over a row's slots).
GAT_TOL = 3e-5


def _gat_records(torch, gk, table, lv, heads: int, width: int, seed: int) -> dict:
    """One layer's attention at the level's table: the kernels' forward and
    backward held against their plain versions and against the benchmark's
    reference (explicit per-edge tensors, ``perfbench/reference/gat.py``),
    then timed (forward: softmax + aggregation; backward: edge gradient +
    transposed aggregation + the d_a_src sum) beside their bound and the
    plain versions."""
    from perfbench.models import gat as bench_gat
    from perfbench.reference import gat as ref_gat

    n = table.num_nodes
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    z = torch.randn((n, heads * width), generator=gen, device=DEVICE)
    a_src = 2 * torch.randn((n, heads), generator=gen, device=DEVICE)
    a_dst = 2 * torch.randn((n, heads), generator=gen, device=DEVICE)
    cot = torch.randn((n, heads * width), generator=gen, device=DEVICE)
    leaves = [t.clone().requires_grad_(True) for t in (z, a_src, a_dst)]
    out = gk.gat_attention(*leaves, table)
    got = [out.detach()] + list(torch.autograd.grad(out, leaves, cot))
    del out, leaves

    def plain():
        alpha, lse = gk.softmax_plain(table.idx, table.mask, a_src, a_dst)
        o = gk.aggregate_plain(table.idx, alpha, z)
        dpre_t, alpha_t, d_a_dst = gk.edge_grad_plain(table.idx, table.mask, table.perm,
                                                      table.k_t, z, cot, o, a_src, a_dst, lse)
        return [o, gk.aggregate_plain(table.idx_t, alpha_t, cot), dpre_t.sum(1), d_a_dst]

    rec = {"heads": heads, "width": width, "rows": n, "edges": table.num_edges, "k": table.k,
           "k_t": table.k_t}
    names = ("out", "dz", "d_a_src", "d_a_dst")
    with torch.no_grad():
        want = plain()
    rec["max_rel_err_plain"] = {}
    for name, g, w in zip(names, got, want):
        rec["max_rel_err_plain"][name] = float((g - w).abs().max()) / float(w.abs().max())
    del want
    torch.cuda.empty_cache()
    # The benchmark's reference: autograd through explicit per-edge tensors.
    ref_leaves = [t.clone().requires_grad_(True) for t in (z, a_src, a_dst)]
    ref = ref_gat.attention(ref_leaves[0].reshape(n, heads, width), ref_leaves[1],
                            ref_leaves[2], lv).reshape(n, -1)
    want = [ref.detach()] + list(torch.autograd.grad(ref, ref_leaves, cot))
    del ref, ref_leaves
    rec["max_rel_err_reference"] = {}
    for name, g, w in zip(names, got, want):
        err = float((g - w).abs().max()) / float(w.abs().max())
        rec["max_rel_err_reference"][name] = err
        if err > GAT_TOL or rec["max_rel_err_plain"][name] > GAT_TOL:
            fail(f"gat {heads} x {width}: {name} differs from the plain version or the "
                 f"reference ({rec['max_rel_err_plain'][name]}, {err})")
    del want, got
    torch.cuda.empty_cache()

    z.requires_grad_(True)
    out_kept = {}

    def forward():
        alpha, lse = gk.softmax(table.idx, table.mask, a_src, a_dst)
        out_kept["out"] = gk.aggregate(table.idx, alpha, z.detach())
        out_kept["lse"] = lse

    forward()

    def edge_grad():
        return gk.edge_grad(table.idx, table.mask, table.perm, table.k_t, z.detach(), cot,
                            out_kept["out"], a_src, a_dst, out_kept["lse"])

    def backward():
        dpre_t, alpha_t, _ = edge_grad()
        gk.aggregate(table.idx_t, alpha_t, cot, "bwd")
        dpre_t.sum(1)

    def fwd_plain():
        alpha, _ = gk.softmax_plain(table.idx, table.mask, a_src, a_dst)
        gk.aggregate_plain(table.idx, alpha, z.detach())

    alpha, lse = gk.softmax(table.idx, table.mask, a_src, a_dst)
    alpha_t = edge_grad()[1]
    kernels = {
        "gat_softmax": lambda: gk.softmax(table.idx, table.mask, a_src, a_dst),
        "gat_aggregate": lambda: gk.aggregate(table.idx, alpha, z.detach()),
        "gat_edge_grad": edge_grad,
        "gat_aggregate_t": lambda: gk.aggregate(table.idx_t, alpha_t, cot, "bwd"),
    }
    with torch.no_grad():
        rec["forward_ms"] = _device_ms(torch, forward, 5, 3)
        rec["backward_ms"] = _device_ms(torch, backward, 5, 3)
        rec["forward_wrapper_ms"] = _wrapper_ms(torch, forward, 5)
        rec["forward_plain_ms"] = _device_ms(torch, fwd_plain, 2, 2)
        for name, fn in kernels.items():
            rec[f"{name}_ms"] = _device_ms(torch, fn, 5, 3)
    shape = bench_gat.StepShape(rows=n, edges=table.num_edges, in_dim=0,
                                layers=((0, heads, width, False),), dtype="float32")
    peaks = {"float32": PEAK_OPS_PER_S["float32"], "bytes_per_s": HBM_BYTES_PER_S}
    bounds = [max(b / HBM_BYTES_PER_S, o / PEAK_OPS_PER_S["float32"]) * 1e3
              for _, b, o in bench_gat.attention_launches(shape)]
    rec["bound_ms"] = dict(zip(("gat_softmax", "gat_aggregate", "gat_edge_grad",
                                "gat_aggregate_t"), bounds))
    rec["forward_bound_ms"] = bounds[0] + bounds[1]
    rec["backward_bound_ms"] = bounds[2] + bounds[3]
    rec["least_ms"] = bench_gat.attention_least_seconds(shape, peaks) * 1e3
    # Rows of z gathered by the aggregation, and its rate.
    rec["gathered_gb"] = table.num_edges * heads * width * 4 / 1e9
    rec["gathered_tb_per_s"] = rec["gathered_gb"] / rec["gat_aggregate_ms"]
    del z, a_src, a_dst, cot, alpha, alpha_t, lse, out_kept, kernels
    torch.cuda.empty_cache()
    return rec


def check_gat_kernels(torch, gk, graph_path: str) -> list:
    """GAT's attention (``csrc/gat.cu``) on the n = 4 level's table at the
    PPI model's layer shapes (4 x 256, 6 x 121; the second takes the
    one-element body): each launch held to its plain version and the
    benchmark's reference within ``GAT_TOL`` of the largest element, and
    timed.  One ``gat`` line a shape."""
    from protgram_directgcn_torch.graph.structure import load_graph

    graph = load_graph(graph_path)
    from perfbench.reference import gat as ref_gat

    table = gk.build_table(graph.src, graph.tgt, graph.num_nodes, device=DEVICE)
    lv = ref_gat.from_edges(torch.from_numpy(graph.src.astype("int64")).to(DEVICE),
                            torch.from_numpy(graph.tgt.astype("int64")).to(DEVICE),
                            graph.num_nodes, graph.n)
    if lv.num_edges != table.num_edges:
        fail(f"gat: the table holds {table.num_edges} edges, the reference {lv.num_edges}")
    gk.reset_launches()
    records = []
    for i, (heads, width) in enumerate(GAT_LAYERS):
        rec = _gat_records(torch, gk, table, lv, heads, width, seed=40 + i)
        emit("gat", **rec)
        records.append(rec)
    launches = gk.launch_counts()
    if min(c for per in launches.values() for c in per.values()) <= 0:
        fail(f"gat: a kernel was not launched ({launches})")
    return records


# -----------------------------------------------------------------------------
# Phase 12: tier path
# -----------------------------------------------------------------------------


def run_tier_path(torch, hk, rt, fasta: str, workdir: str):
    """``--stages graph,gcn`` to n = TIER_N with the plan's budget pinned;
    returns the K1/K2 and retile launch counts of the run, the run's config
    and the n = TIER_N graph's path."""
    from protgram_directgcn_torch.pipeline.trainer import HierarchicalTrainer

    dims = ",".join(str(d) for d in TIER_DIMS)
    argv = ["--fasta", fasta, "--out", os.path.join(workdir, "tier_out"),
            "--stages", "graph,gcn",
            "--set", f"graph_builder.ngram_max_n={TIER_N}",
            "--set", "gcn.default_task_type=closest_aa",
            "--set", f"gcn.hidden_layer_dims=[{dims}]",
            "--set", "gcn.epochs_per_level=3",
            "--set", "gcn.run_sanity_check_ppi=false",
            "--device", DEVICE]
    HierarchicalTrainer._hbm_override = TIER_PIN
    hk.reset_launches()
    rt.reset_launches()
    try:
        result, seconds = _drive(torch, argv)
    finally:
        HierarchicalTrainer._hbm_override = None
    counts = {**hk.launch_counts(), **rt.launch_counts()}

    trainer = result["trainer"]
    stats = trainer.level_stats
    for n in range(1, TIER_N + 1):
        if n not in stats:
            fail(f"tier path: level n={n} did not train")
        st = stats[n]
        plan = st["plan"]
        if not _finite(st["losses"]):
            fail(f"tier path: level n={n} has non-finite losses {st['losses']}")
        if n >= 2 and st["route"] != "hypercube":
            fail(f"tier path: level n={n} took the {st['route']} route, not hypercube")
        want = (3, "bfloat16", "bfloat16", True, True, True) if n == TIER_N else (
            0, "float32", "float32", False, False, False)
        got = tuple(plan[k] for k in ("tier", "compute_dtype", "node_param_dtype", "remat",
                                      "remat_paths", "factored"))
        if got != want:
            fail(f"tier path: level n={n} planned {got}, expected {want}")
        check_optimizer_routes(f"tier path n={n}", st, adafactor=plan["factored"])
        check_epilogue_route(f"tier path n={n}", st, fused=n != TIER_N)
        emit("tier_path_level", level=n, **st)
    last = stats[TIER_N]
    for k in ("k1", "k2", "pack", "unpack"):
        for direction in ("fwd", "bwd"):
            if last["launches"][k][direction] <= 0:
                fail(f"tier path: level n={TIER_N}: {k} {direction} was never launched")
    emit("tier_path", seconds=seconds, launches=counts, pin_bytes=TIER_PIN,
         graph_etl_seconds=_native_etl(result, "tier path"), **_pooled(result, TIER_DIMS[-1]))

    return counts, trainer.config, result["graphs"], last["peak_device_bytes"]


def run_free_memory_level(torch, config, graph_path: str, tier3_peak: int):
    """The n = TIER_N level trained through ``train_level`` with the plan
    from the card's real free memory (no pin), on seeded features of the
    previous level's width and seeded labels of the tier path's class count
    (memory does not depend on their values): its plan, each tier's
    residency estimate and the measured peak."""
    import numpy as np

    from protgram_directgcn_torch.graph.structure import load_graph
    from protgram_directgcn_torch.ops.hypercube import vocab_char_codes
    from protgram_directgcn_torch.pipeline.trainer import TIER_LEVERS, HierarchicalTrainer

    graph = load_graph(graph_path)
    trainer = HierarchicalTrainer(config, device=DEVICE)
    budget = trainer._device_memory()
    _, alpha = vocab_char_codes(graph.vocab)
    n_hyper = max(alpha**TIER_N, graph.num_nodes)
    estimates = {tier: sum(trainer._residency(n_hyper, TIER_DIMS[-1], TIER_CLASSES, *lv,
                                              staged=tier == 4))
                 for tier, lv in TIER_LEVERS.items()}
    rng = np.random.default_rng(9)
    x = rng.standard_normal((graph.num_nodes, TIER_DIMS[-1])).astype(np.float32)
    y = rng.integers(0, TIER_CLASSES, graph.num_nodes)
    t0 = time.monotonic()
    trainer.train_level(graph, x, y, TIER_CLASSES)  # the returned tensors are dropped here
    seconds = time.monotonic() - t0
    st = trainer.level_stats[TIER_N]
    if not _finite(st["losses"]) or st["route"] != "hypercube":
        fail(f"free-memory level: route {st['route']}, losses {st['losses']}")
    check_optimizer_routes("free-memory level", st, adafactor=st["plan"]["factored"])
    torch.cuda.empty_cache()
    emit("tier_plan_free_memory", level=TIER_N, hypercube_nodes=n_hyper,
         device_budget_bytes=budget, level_seconds=seconds, **st,
         residency_estimate_bytes_by_tier=estimates,
         slack_and_min_bank_bytes=trainer._PLAN_SLACK + trainer._MIN_BANK,
         measured_peak_bytes_at_tier_3=tier3_peak)


# -----------------------------------------------------------------------------
# Phases 14-17: native ETL, checkpoints, tier 4 and the degrade policy
# -----------------------------------------------------------------------------


def check_native_etl(fasta: str):
    """The FASTA's n = 1..4 graphs by the C++ ETL and by numpy: byte-equal
    arrays, each way's seconds."""
    from protgram_directgcn_torch import native
    from protgram_directgcn_torch.graph.builder import NgramGraphBuilder
    from protgram_directgcn_torch.utils.io import parse_fasta

    seqs = list(parse_fasta(fasta))
    graphs, ways = {}, {}
    for way in ("native", "numpy"):
        builder = NgramGraphBuilder(n_max=4, use_native=way == "native")
        t0 = time.monotonic()
        graphs[way] = builder.build_from_sequences(seqs)
        ways[way] = {"seconds": time.monotonic() - t0,
                     "level_seconds": {str(n): st["seconds"] for n, st in builder.stats.items()}}
        took = {n: st["etl"] for n, st in builder.stats.items()}
        if set(took.values()) != {way}:
            fail(f"native_etl: the {way} build took {took}")
    for a, b in zip(graphs["native"], graphs["numpy"]):
        for field in ("vocab", "src", "tgt", "weight"):
            x, y = getattr(a, field), getattr(b, field)
            if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                fail(f"native_etl: n={a.n} {field} differs between the C++ and numpy ETL")
    emit("native_etl", levels=4, sequences=len(seqs), byte_equal=True,
         nodes={str(g.n): g.num_nodes for g in graphs["native"]},
         edges={str(g.n): g.num_edges for g in graphs["native"]},
         native_seconds=ways["native"]["seconds"], numpy_seconds=ways["numpy"]["seconds"],
         by_level=ways, build={k: native.BUILD_INFO.get(k) for k in ("path", "seconds", "built")})


def _cpu_leaves(torch, params):
    from protgram_directgcn_torch.models.directgcn import param_leaves

    return [p.detach().float().cpu() for p in param_leaves(params)]


def _leaves_close(torch, got, ref, rtol: float, atol_rel: float, what: str) -> float:
    """Fail unless every leaf is within rtol and atol_rel * max|leaf|;
    returns the worst error relative to its leaf's max."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        scale = max(1.0, float(b.abs().max()))
        err = (a - b).abs()
        if not bool(torch.isfinite(a).all()) or not bool(
                (err <= atol_rel * scale + rtol * b.abs()).all()):
            fail(f"{what}: leaf {i} differs, max abs err {float(err.max())}")
        worst = max(worst, float(err.max()) / scale)
    return worst


def check_checkpoint(torch, hk, graph_path: str, workdir: str):
    """The main path's n = 3 level through ``train_level`` with
    ``checkpoint_every_epochs=2`` and the default dropout: cut after 4
    epochs, resumed to 6, against an uncut 6-epoch run (rtol 1e-6, atol
    1e-6 x max|leaf|); both metric logs; then three float32 steps of the
    staged step against the fused one from the same parameters, dropout 0
    (rtol 1e-4, atol 1e-5 x max|leaf|, the CPU tests' tolerance)."""
    import numpy as np

    from protgram_directgcn_torch.config import Config
    from protgram_directgcn_torch.graph.structure import load_graph
    from protgram_directgcn_torch.models import directgcn
    from protgram_directgcn_torch.pipeline import trainer as tr
    from protgram_directgcn_torch.pipeline.labels import next_node_labels
    from protgram_directgcn_torch.utils.metrics import MetricLogger, read_metrics

    graph = load_graph(graph_path)
    y, classes = next_node_labels(graph)
    x = np.random.default_rng(13).standard_normal((graph.num_nodes, TIER_DIMS[-1])).astype(
        np.float32)
    root = os.path.join(workdir, "checkpoint")

    def level(epochs: int, run: str):
        config = Config()
        config.gcn.hidden_layer_dims = list(TIER_DIMS)
        config.gcn.epochs_per_level = epochs
        config.gcn.checkpoint_every_epochs = CHECKPOINT_EVERY
        trainer = tr.HierarchicalTrainer(config, device=DEVICE)
        with MetricLogger(os.path.join(root, run, "run_n3"), "gcn_n3") as metrics:
            params = trainer.train_level(graph, x, y, classes, metrics=metrics,
                                         ckpt_dir=os.path.join(root, run, "train_state_n3"))[0]
        return _cpu_leaves(torch, params), trainer.level_stats[3]

    hk.reset_launches()
    t0 = time.monotonic()
    level(4, "cut")
    cut_steps = sorted(os.listdir(os.path.join(root, "cut", "train_state_n3")))
    resumed, res_st = level(6, "cut")
    uncut, uncut_st = level(6, "uncut")
    seconds = time.monotonic() - t0
    counts = hk.launch_counts()
    if cut_steps != ["step_2", "step_4"] or res_st["start_epoch"] != 5 or res_st["epochs"] != 2:
        fail(f"checkpoint: the cut run saved {cut_steps}; the resumed one started at epoch "
             f"{res_st['start_epoch']} and ran {res_st['epochs']}")
    if res_st["route"] != "hypercube" or not all(counts[k][d] for k in counts
                                                 for d in ("fwd", "bwd")):
        fail(f"checkpoint: route {res_st['route']}, K1/K2 launches {counts}")
    worst = _leaves_close(torch, resumed, uncut, 1e-6, 1e-6, "checkpoint: resumed vs uncut")
    logs = {run: read_metrics(os.path.join(root, run, "run_n3")) for run in ("cut", "uncut")}
    for run, recs in logs.items():
        if ([r.get("step") for r in recs] != list(range(1, 7)) or any(
                set(r) != {"t", "run", "step", "level", "loss", "lr"} or r["level"] != 3
                for r in recs)):
            fail(f"checkpoint: the {run} run's metrics.jsonl holds {recs}")
    loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(logs["cut"][4:], logs["uncut"][4:]))
    if loss_err > 1e-6:
        fail(f"checkpoint: resumed losses differ from the uncut run's by {loss_err}")

    # Staged (tier 4) against fused, float32, at the main path's n = 3 shape.
    dg = graph.to_device(mode="hypercube", device=DEVICE)
    dims = (TIER_DIMS[-1],) + TIER_DIMS
    cfg = directgcn.DirectGCNConfig(layer_dims=dims, num_nodes=dg.num_nodes, num_classes=classes,
                                    n_gram_len=3, dropout=0.0, decoder_dropout=0.0, remat=True,
                                    remat_paths=True)
    params0 = tr._node_params_to_rg(directgcn.init_directgcn_params(
        torch.Generator().manual_seed(6), cfg, "cpu"), dg)
    lead = dg.p_in.feature_shape
    node_map = dg.node_map.cpu().numpy()
    xs = np.zeros((dg.num_nodes, dims[0]), np.float32)
    xs[node_map] = x
    ys = np.zeros(dg.num_nodes, np.int64)
    ys[node_map] = y
    ms = np.zeros(dg.num_nodes, np.float32)
    ms[node_map] = 1.0
    xt = torch.from_numpy(xs).to(DEVICE).reshape(lead + (dims[0],))
    yt, mt = torch.from_numpy(ys).to(DEVICE), torch.from_numpy(ms).to(DEVICE)
    runs = {}
    for staged in (False, True):
        params = _tree_to(torch, params0, DEVICE)
        for p in directgcn.param_leaves(params):
            p.requires_grad_(True)
        opt = tr.make_optimizer(params, 1e-3, 0.0, factor_node_params_above=dg.num_nodes)
        step = (tr.make_train_step_staged if staged else tr.make_train_step)(cfg, opt, 1e-7)
        losses = [float(step(params, dg, xt, yt, mt, 1.0, None)[0]) for _ in range(3)]
        runs[staged] = (losses, _cpu_leaves(torch, params))
        del params, opt, step
    staged_worst = _leaves_close(torch, runs[True][1], runs[False][1], 1e-4, 1e-5,
                                 "checkpoint: staged vs fused")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs[True][0], runs[False][0]))
    if loss_rel > 1e-4:
        fail(f"checkpoint: staged losses {runs[True][0]} vs fused {runs[False][0]}")
    del dg, xt
    torch.cuda.empty_cache()
    emit("checkpoint", level=3, nodes=graph.num_nodes, every=CHECKPOINT_EVERY,
         cut_checkpoints=cut_steps, resumed_start_epoch=res_st["start_epoch"],
         resumed_vs_uncut_worst_rel=worst, resumed_loss_rel_err=loss_err,
         metrics_lines={run: len(recs) for run, recs in logs.items()},
         losses={"resumed": res_st["losses"], "uncut": uncut_st["losses"]},
         level_seconds=seconds, k1k2_launches=counts,
         staged_vs_fused={"losses_fused": runs[False][0], "losses_staged": runs[True][0],
                          "loss_rel_err": loss_rel, "worst_rel": staged_worst})


def run_tier4_level(torch, hk, rt, config, graph_path: str, tier3_peak: int):
    """The 5-gram level through ``train_level`` with the plan's budget
    pinned halfway between its tier-4 and tier-3 needs: tier 4, the
    hypercube route, finite losses, K1/K2/pack/unpack forward and backward;
    the peak beside the tier-3 peak; the tier-3 and tier-4 needs at
    Swiss-Prot's 5-gram level."""
    import numpy as np

    from protgram_directgcn_torch.graph.structure import load_graph
    from protgram_directgcn_torch.ops.hypercube import vocab_char_codes
    from protgram_directgcn_torch.pipeline.trainer import TIER_LEVERS, HierarchicalTrainer

    graph = load_graph(graph_path)
    trainer = HierarchicalTrainer(config, device=DEVICE)
    _, alpha = vocab_char_codes(graph.vocab)
    n_hyper = max(alpha**TIER_N, graph.num_nodes)
    floor = trainer._PLAN_SLACK + trainer._MIN_BANK

    def need(nodes: int, tier: int) -> int:
        return sum(trainer._residency(nodes, TIER_DIMS[-1], TIER_CLASSES, *TIER_LEVERS[tier],
                                      staged=tier == 4))

    needs = {tier: need(n_hyper, tier) for tier in (3, 4)}
    pin = floor + (needs[3] + needs[4]) // 2
    trainer._hbm_override = pin
    rng = np.random.default_rng(10)
    x = rng.standard_normal((graph.num_nodes, TIER_DIMS[-1])).astype(np.float32)
    y = rng.integers(0, TIER_CLASSES, graph.num_nodes)
    hk.reset_launches()
    rt.reset_launches()
    t0 = time.monotonic()
    trainer.train_level(graph, x, y, TIER_CLASSES)
    seconds = time.monotonic() - t0
    counts = {**hk.launch_counts(), **rt.launch_counts()}
    st = trainer.level_stats[TIER_N]
    if (st["plan"]["tier"], st["staged"], st["route"]) != (4, True, "hypercube") or not _finite(
            st["losses"]):
        fail(f"tier-4 level: plan tier {st['plan']['tier']}, staged {st['staged']}, route "
             f"{st['route']}, losses {st['losses']}")
    for k in ("k1", "k2", "pack", "unpack"):
        for direction in ("fwd", "bwd"):
            if st["launches"][k][direction] <= 0:
                fail(f"tier-4 level: {k} {direction} was never launched")
    check_optimizer_routes("tier-4 level", st, adafactor=st["plan"]["factored"])
    torch.cuda.empty_cache()
    swiss = {str(tier): need(SWISSPROT_HYPER_NODES, tier) + floor for tier in (3, 4)}
    emit("tier4_level", level=TIER_N, hypercube_nodes=n_hyper, pin_bytes=pin,
         need_bytes_with_floor={str(t): v + floor for t, v in needs.items()},
         level_seconds=seconds, phase_launches=counts, **st,
         tier3_peak_bytes=tier3_peak,
         swissprot_5gram={"hypercube_nodes": SWISSPROT_HYPER_NODES,
                          "need_bytes_with_floor": swiss})


def run_degrade_level(torch, config, graph_path: str):
    """The 4-gram level with the plan's budget pinned halfway between its
    tier-4 needs at the configured dims and at half of them: the degrade
    policy names the halved dims and the level trains at them."""
    import numpy as np

    from protgram_directgcn_torch.graph.structure import load_graph
    from protgram_directgcn_torch.ops.hypercube import vocab_char_codes
    from protgram_directgcn_torch.pipeline.trainer import TIER_LEVERS, HierarchicalTrainer

    graph = load_graph(graph_path)
    trainer = HierarchicalTrainer(config, device=DEVICE)
    _, alpha = vocab_char_codes(graph.vocab)
    n_hyper = max(alpha**graph.n, graph.num_nodes)
    half = tuple(d // 2 for d in TIER_DIMS)

    def need(dims) -> int:
        return sum(trainer._residency(n_hyper, TIER_DIMS[-1], TIER_CLASSES, *TIER_LEVERS[4],
                                      staged=True, out_dims=dims))

    pin = trainer._PLAN_SLACK + trainer._MIN_BANK + (need(TIER_DIMS) + need(half)) // 2
    trainer._hbm_override = pin
    rng = np.random.default_rng(12)
    x = rng.standard_normal((graph.num_nodes, TIER_DIMS[-1])).astype(np.float32)
    y = rng.integers(0, TIER_CLASSES, graph.num_nodes)
    t0 = time.monotonic()
    emb = trainer.train_level(graph, x, y, TIER_CLASSES)[1]
    seconds = time.monotonic() - t0
    st = trainer.level_stats[graph.n]
    want = [TIER_DIMS[-1]] + list(half)
    if (tuple(st["plan"]["layer_dims_override"] or ()) != half or st["layer_dims"] != want
            or emb.shape != (graph.num_nodes, half[-1]) or not _finite(st["losses"])):
        fail(f"degrade level: planned {st['plan']['layer_dims_override']}, trained "
             f"{st['layer_dims']}, embeddings {emb.shape}, losses {st['losses']}")
    torch.cuda.empty_cache()
    emit("degrade_level", level=graph.n, hypercube_nodes=n_hyper, pin_bytes=pin,
         configured_dims=list(TIER_DIMS), level_seconds=seconds, **st)


class _OperatorCache:
    """``HierarchicalTrainer._to_device_graph`` memoised by level and
    compute type while active, for the levels in ``levels``: phases 12, 13
    and 16 train the same 5-gram level on the same bf16 operators, built
    once on the host."""

    def __init__(self, trainer_cls, levels=(TIER_N,)):
        self.cls, self.real, self.built = trainer_cls, trainer_cls._to_device_graph, {}
        self.levels = set(levels)

    def __enter__(self):
        real, built, levels = self.real, self.built, self.levels

        def cached(trainer, graph, plan, feat_dim=128):
            if graph.n not in levels:
                return real(trainer, graph, plan, feat_dim)
            key = (graph.n, plan.compute_dtype)
            if key not in built:
                built[key] = real(trainer, graph, plan, feat_dim)
            return built[key]

        self.cls._to_device_graph = cached
        return self

    def __exit__(self, *exc):
        self.cls._to_device_graph = self.real
        self.built.clear()


# -----------------------------------------------------------------------------


# -----------------------------------------------------------------------------
# Phase 18: the GNN zoo benchmark
# -----------------------------------------------------------------------------


def run_benchmark(torch, ek, workdir: str):
    """``--stages benchmark`` at every default but ``benchmark.epochs`` (300
    cut to ``BENCH_EPOCHS``) and ``benchmark.n_seeds`` (10 cut to
    ``BENCH_SEEDS``), each model's training under ``torch.profiler``
    (``GNNBenchmarker.PROFILE``), with the ELL kernels' launch counts set to
    0 before and read after.  Fails on an ``error`` row, a non-finite
    accuracy, or an ELL kernel launched no time in either direction.
    Returns the counts, by direction and by ``v``."""
    import numpy as np

    from protgram_directgcn_torch.bench import datasets as bd
    from protgram_directgcn_torch.bench.gnn_benchmarker import GNNBenchmarker

    argv = ["--out", os.path.join(workdir, "bench"), "--stages", "benchmark", "--device", DEVICE,
            "--set", f"benchmark.epochs={BENCH_EPOCHS}", "--set", f"benchmark.n_seeds={BENCH_SEEDS}"]
    GNNBenchmarker.PROFILE = True
    ek.reset_launches()
    try:
        result, seconds = _drive(torch, argv)
    finally:
        GNNBenchmarker.PROFILE = False
    counts, by_v = ek.launch_counts(), ek.launch_counts_by_v()
    rows = result["benchmark_results"]
    bench_cfg = result["benchmarker"].bench
    want_rows = len(bench_cfg.node_classification_datasets) * 2 * 10
    bad = [r for r in rows if "error" in r
           or not _finite([r["best_val_accuracy"], r["test_accuracy"]])]
    if bad or len(rows) != want_rows:
        fail(f"benchmark: {len(rows)} rows (want {want_rows}); failed or non-finite: {bad}")
    for name in ("ell_resident", "ell_hbm"):
        if not (counts[name]["fwd"] and counts[name]["bwd"]):
            fail(f"benchmark: {name} launched {counts[name]} (forward and backward expected)")
    models = {}
    for variant, per_model in result["benchmarker"].stats.items():
        for model, st in per_model.items():
            busy = st["busy"]
            models.setdefault(variant, {})[model] = {
                "seconds": st["seconds"], "steps": st["steps"],
                "steps_per_second": st["steps"] / st["seconds"],
                "save_seconds": st["save_seconds"],
                "device_seconds": busy["device_seconds"], "busy_share": busy["busy_share"],
                "formats": st["formats"]}
    accuracy = {f"{r['dataset']}/{r['model']}": r["test_accuracy"] for r in rows}
    datasets = {}
    for name in bench_cfg.node_classification_datasets:
        ds = bd.load_dataset(name, None, result["benchmarker"].config.random_state)
        datasets[name] = {"nodes": ds.num_nodes, "edges": int(ds.edge_index.shape[1]),
                          "features": int(ds.x.shape[1]), "classes": ds.num_classes,
                          "synthetic": ds.synthetic,
                          "standin_seed_offset": (hash(name) % 1000 if ds.synthetic else None)}
    emit("benchmark", wall_seconds=seconds, stage_seconds=result["seconds"],
         cut=f"benchmark.epochs 300 -> {BENCH_EPOCHS}, benchmark.n_seeds 10 -> {BENCH_SEEDS}",
         rows=len(rows), datasets=datasets, ell_launches=counts,
         ell_launches_by_v={k: {str(v): n for v, n in d.items()} for k, d in by_v.items()},
         profiled="torch.profiler over each model's training (the CUDA activity only)",
         models=models, test_accuracy=accuracy,
         mean_test_accuracy=float(np.mean(list(accuracy.values()))))
    return counts, by_v


def _bench_operator(torch, name: str, kind: str):
    """An operator of the benchmark path as ELL on the card: the GCN
    operator (``kind="gcn"``, positive weights) or ChebNet's Laplacian
    (``kind="cheb"``, negative weights) of the stand-in ``name``."""
    from protgram_directgcn_torch.bench.datasets import load_dataset
    from protgram_directgcn_torch.models import zoo
    from protgram_directgcn_torch.ops import spmm

    ds = load_dataset(name, None, 42)
    builder = zoo._gcn_norm_adj if kind == "gcn" else zoo._cheb_operator
    with _zoo_format(zoo, "ell"):
        adj = builder(ds.edge_index, None, ds.num_nodes, 256, DEVICE)
    if not isinstance(adj, spmm.EllAdj):
        fail(f"bench operator {name}/{kind}: built {type(adj).__name__}")
    return adj, ds


@contextlib.contextmanager
def _zoo_format(zoo, mode: str):
    """Within the block the zoo's operator builders build ``mode``."""
    import functools

    from protgram_directgcn_torch.ops import spmm

    zoo.build_adjacency = functools.partial(spmm.build_adjacency, mode=mode)
    try:
        yield
    finally:
        zoo.build_adjacency = spmm.build_adjacency


def check_bench_ell(torch, ek) -> list:
    """The ELL kernels at the benchmark's narrow widths (F = class counts 2-7
    and KarateClub's 34 identity features; all take v = 1), forward and the
    autograd backward, against the plain versions, and timed: ``ell_resident``
    on Cora's ChebNet Laplacian (negative weights, 2,708 nodes), ``ell_hbm``
    on PubMed's GCN operator (19,717 nodes, past the resident regime)."""
    records = []
    for name, dataset, kind in (("ell_resident", "Cora", "cheb"), ("ell_hbm", "PubMed", "gcn")):
        adj, ds = _bench_operator(torch, dataset, kind)
        want = ek.resident_supported(ds.num_nodes)
        if want != (name == "ell_resident"):
            fail(f"bench ell: {dataset} ({ds.num_nodes} nodes) does not take {name}")
        n_out, k = adj.idx.shape
        for f in BENCH_WIDTHS:
            gen = torch.Generator(device=DEVICE).manual_seed(1000 + f)
            x = torch.randn(n_out, f, generator=gen, device=DEVICE)
            cot = torch.randn(n_out, f, generator=gen, device=DEVICE)
            what = f"{dataset} {kind} F={f}"
            rec = {"name": name, "dataset": dataset, "operator": kind, "f": f, "n_out": n_out,
                   "k": k, "k_t": int(adj.idx_t.shape[1]),
                   "negative_weights": bool((adj.w < 0).any())}
            rec.update(_check_ell_both_ways(torch, ek, name, adj, x, cot, what, want_v=1))
            rec.update(_ell_timed(torch, ek, name, adj.idx, adj.w, x, iters=50))
            rec["wrapper_ms"] = _wrapper_ms(torch, lambda: getattr(ek, name)(adj.idx, adj.w, x),
                                            200)
            records.append(rec)
    emit("bench_ell_kernels", widths=list(BENCH_WIDTHS), records=records)
    return records


def check_bench_reference(torch, ek) -> None:
    """One model a format on the card and on the CPU from the same
    parameters, dropout 0, ``BENCH_REF_EPOCHS`` epochs of the benchmarker's
    ``train_and_evaluate``: GCN on KarateClub (dense), ChebNet on Cora with
    its Laplacian built as ELL (``ell_resident``), GCN on PubMed (bucketed
    ELL, ``ell_hbm``).  Losses within ``BENCH_REF_TOL[0]`` relative, the
    validation accuracies equal.  The best parameters: every element within
    Adam's bound, 2 * lr a step, and at most ``BENCH_REF_TOL[2]`` of each
    leaf's elements past 1e-5 * max|leaf| + ``BENCH_REF_TOL[1]`` * lr a
    step.  Adam normalises each element's step, so an element whose
    gradient is a cancellation residue, summed in another order, moves by a
    share of lr: on the CPU alone, ChebNet on ELL with the slots summed in
    reverse put up to 0.03% of a leaf's elements past that allowance, by up
    to 2.8% of Adam's bound, over 22 stand-ins."""
    from protgram_directgcn_torch.bench.datasets import load_dataset
    from protgram_directgcn_torch.bench.gnn_benchmarker import (
        GNNBenchmarker,
        operator_formats,
        seeded_split,
    )
    from protgram_directgcn_torch.models import zoo
    from protgram_directgcn_torch.models.directgcn import param_leaves

    cases = (("KarateClub", "GCN", "auto", ["dense"]), ("Cora", "ChebNet", "ell", ["ell"]),
             ("PubMed", "GCN", "auto", ["bucketed"]))
    lr = 1e-3
    out = {}
    for dataset, model_name, mode, want in cases:
        ds = load_dataset(dataset, None, 42)
        masks = None
        runs = []
        for card, dev in ((True, DEVICE), (False, "cpu")):
            with _zoo_format(zoo, mode):
                model = zoo.ZOO_MODELS[model_name](
                    edge_index=ds.edge_index, num_nodes=ds.num_nodes, in_dim=ds.x.shape[1],
                    out_dim=ds.num_classes, hidden_dim=256, dropout_rate=0.0, device=dev)
            if operator_formats(model) != want:
                fail(f"bench reference {dataset}/{model_name}: formats "
                     f"{operator_formats(model)}, expected {want}")
            bench = GNNBenchmarker(device=dev)
            if masks is None:
                masks = seeded_split(ds.num_nodes, bench.bench.split_ratios, 42)
            params = bench._zoo_init(model)(7)
            ek.reset_launches()
            t0 = time.monotonic()
            run = bench.train_and_evaluate(model_name, model.apply, params, ds, masks,
                                           BENCH_REF_EPOCHS, lr, 5e-4, 7)
            if card:
                torch.cuda.synchronize()
                launches = ek.launch_counts()
            runs.append(run + (time.monotonic() - t0,))
        (_, _, ch, cp, c_s), (_, _, hh, hp, h_s) = runs
        rtol, lr_share, max_share = BENCH_REF_TOL
        loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(ch, hh))
        if loss_rel > rtol or [a["val_accuracy"] for a in ch] != [b["val_accuracy"] for b in hh]:
            fail(f"bench reference {dataset}/{model_name}: losses {ch} against {hh}")
        worst, share = 0.0, 0.0
        bound = 2 * lr * BENCH_REF_EPOCHS
        for a, b in zip(param_leaves(cp), param_leaves(hp)):
            err = (a.cpu() - b).abs()
            allowed = 1e-5 * float(b.abs().max()) + lr_share * lr * BENCH_REF_EPOCHS
            worst = max(worst, float(err.max()) / allowed)
            share = max(share, float((err > allowed).float().mean()))
            if float(err.max()) > bound or share > max_share:
                fail(f"bench reference {dataset}/{model_name}: a parameter {float(err.max())} "
                     f"off (bound {bound}), {share} of a leaf past {allowed}")
        out[f"{dataset}/{model_name}"] = {
            "formats": want, "epochs": BENCH_REF_EPOCHS, "loss_max_rel_err": loss_rel,
            "param_err_over_allowed": worst, "share_past_allowed": share,
            "card_seconds": c_s, "cpu_seconds": h_s, "card_ell_launches": launches}
    emit("bench_reference", tolerance={
        "loss_rtol": BENCH_REF_TOL[0], "params": "every element within 2 * lr * epochs; at "
        "most %g of a leaf past 1e-5 * max|leaf| + %g * lr * epochs" % BENCH_REF_TOL[2:0:-1]},
        cases=out)


# -----------------------------------------------------------------------------
# Phase 19: SDDMM edge gradients
# -----------------------------------------------------------------------------

SDDMM_F = 64  # the edge-list formats' width (their CPU references gather N x K x F)
SDDMM_HYPER_F = 256


def _sddmm_err(got, ref, x, cot, f: int):
    """Max abs error, and whether every element is within rtol 1e-5 and atol
    1e-6 * F * max|x| * max|cotangent| (an f32 dot of F products)."""
    err = (got.float().cpu() - ref.float()).abs()
    atol = 1e-6 * f * float(x.abs().max()) * float(cot.abs().max())
    return float(err.max()), bool((err <= atol + 1e-5 * ref.float().abs()).all())


def _events_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over a host loop, with CUDA events."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_sddmm(torch, ek, hk, graph_paths):
    """``propagate(adj, x, edge_grads=True)`` on the card against the same
    call on the CPU: dw (and dx) of the ELL format at n = 4 (``ell_hbm``),
    bucketed ELL and COO at n = 3 (F = 64), the hypercube's dd, dwf, dwb at
    n = 3 (F = 256, float32 and bfloat16); the ELL products must reach the
    kernels forward and backward and never ``ell_plain``.  Timed: the
    kernel forward, the SDDMM alone, and a forward and backward with and
    without edge gradients (the SDDMM's share of the backward).  Returns
    the card's launches of the ELL kernels and K1/K2 by direction."""
    from protgram_directgcn_torch.graph import transforms
    from protgram_directgcn_torch.graph.structure import load_graph
    from protgram_directgcn_torch.ops import hypercube, spmm

    records = {}
    counts = {name: {"fwd": 0, "bwd": 0} for name in ek.LAUNCHES}
    for fmt, level, builder in (("ell", 4, spmm.build_ell),
                                ("bucketed", 3, spmm.build_bucketed_ell),
                                ("coo", 3, spmm.build_coo)):
        graph = load_graph(graph_paths[level - 1])
        src, tgt, val = transforms.csr_to_coo_arrays(graph.mathcal_a_in())
        n = graph.num_nodes
        gen = torch.Generator().manual_seed(level * 7 + len(fmt))
        x = torch.randn(n, SDDMM_F, generator=gen)
        cot = torch.randn(n, SDDMM_F, generator=gen)
        outs = {}
        for dev in (DEVICE, "cpu"):
            adj = builder(src, tgt, val, n, device=dev)
            leaves = tuple(adj.w) if fmt == "bucketed" else (adj.w,)
            leaves = tuple(w.clone().requires_grad_(True) for w in leaves)
            adj.w = leaves if fmt == "bucketed" else leaves[0]
            xg = x.to(dev, copy=True).requires_grad_(True)
            plain_calls = []
            real_plain = ek.ell_plain
            ek.ell_plain = lambda *a: plain_calls.append(1) or real_plain(*a)
            ek.reset_launches()
            try:
                y = spmm.propagate(adj, xg, edge_grads=True)
                y.backward(cot.to(dev))
                if dev != "cpu":
                    torch.cuda.synchronize()
            finally:
                ek.ell_plain = real_plain
            outs[dev] = {"dw": [w.grad.cpu() for w in leaves], "dx": xg.grad.cpu(),
                         "y": y.detach().cpu(), "adj": adj, "plain": len(plain_calls),
                         "launches": ek.launch_counts()}
        card = outs[DEVICE]
        rec = {"level": level, "n": n, "f": SDDMM_F, "launches": card["launches"],
               "nnz": int(len(src))}
        if fmt != "coo":
            name = "ell_hbm" if level == 4 else "ell_resident"
            for direction in ("fwd", "bwd"):
                if card["launches"][name][direction] <= 0:
                    fail(f"sddmm: {fmt} at n={level} never launched {name} ({direction})")
                counts[name][direction] += card["launches"][name][direction]
            if card["plain"]:
                fail(f"sddmm: {fmt} at n={level} ran ell_plain {card['plain']} times on the card")
        for key, got, ref in ([("dw", g, r) for g, r in zip(card["dw"], outs["cpu"]["dw"])]
                              + [("dx", card["dx"], outs["cpu"]["dx"]),
                                 ("y", card["y"], outs["cpu"]["y"])]):
            err, ok = _sddmm_err(got, ref, x, cot, SDDMM_F)
            rec[f"{key}_max_abs_err"] = max(err, rec.get(f"{key}_max_abs_err", 0.0))
            if not ok:
                fail(f"sddmm: {fmt} at n={level} {key} disagrees with the CPU: max abs err {err}")
        adj = card["adj"]
        xc, cc = x.to(DEVICE), cot.to(DEVICE)
        xw = xc.clone().requires_grad_(True)

        def step(eg):
            def run():
                y = spmm.propagate(adj, xw, edge_grads=eg)
                y.backward(cc)
            return run

        rec["fwd_bwd_ms"] = _events_ms(torch, step(False), 20)
        rec["fwd_bwd_edge_grads_ms"] = _events_ms(torch, step(True), 20)
        rec["sddmm_ms"] = _events_ms(torch, lambda: spmm._sddmm(adj, xc, cc), 20)
        if fmt == "ell":
            kernel = ek.ell_hbm if level == 4 else ek.ell_resident
            rec["kernel_fwd_ms"] = _events_ms(torch, lambda: kernel(adj.idx, adj.w, xc), 20)
        rec["sddmm_share_of_backward"] = 1.0 - rec["fwd_bwd_ms"] / rec["fwd_bwd_edge_grads_ms"]
        records[fmt] = rec
        del outs, card, adj, xc, cc, xw
        torch.cuda.empty_cache()

    graph = load_graph(graph_paths[2])
    src, tgt, val = transforms.csr_to_coo_arrays(graph.mathcal_a_in())
    codes, alpha = hypercube.vocab_char_codes(graph.vocab)
    for dt in ("float32", "bfloat16"):
        tdt = getattr(torch, dt)
        outs = {}
        for dev in (DEVICE, "cpu"):
            adj = hypercube.build_hypercube(src, tgt, val, codes, alpha, weights_dtype=tdt,
                                            device=dev)
            gen = torch.Generator().manual_seed(31)
            x = torch.randn(adj.n_out, SDDMM_HYPER_F, generator=gen).to(tdt)
            cot = torch.randn(adj.n_out, SDDMM_HYPER_F, generator=gen).to(tdt)
            adj.d, adj.wf_rs, adj.wb_rs = (t.clone().requires_grad_(True)
                                           for t in (adj.d, adj.wf_rs, adj.wb_rs))
            xg = x.to(dev, copy=True).requires_grad_(True)
            hk.reset_launches()
            y = hypercube.propagate_hyper_affine(adj, xg, 0.75, 0.125, edge_grads=True)
            y.backward(cot.to(dev))
            if dev != "cpu":
                torch.cuda.synchronize()
            outs[dev] = {k: v.grad.float().cpu() for k, v in (
                ("dd", adj.d), ("dwf", adj.wf_rs), ("dwb", adj.wb_rs), ("dx", xg))}
            outs[dev].update(adj=adj, launches=hk.launch_counts())
        rec = {"level": 3, "shape": list(adj.feature_shape) + [SDDMM_HYPER_F], "dtype": dt,
               "launches": outs[DEVICE]["launches"]}
        for k in ("k1", "k2"):
            if min(outs[DEVICE]["launches"][k].values()) <= 0:
                fail(f"sddmm: hypercube {dt} did not launch {k} both ways")
            for direction, n in outs[DEVICE]["launches"][k].items():
                counts.setdefault(k, {"fwd": 0, "bwd": 0})[direction] += n
        for key in ("dd", "dwf", "dwb", "dx"):
            got, ref = outs[DEVICE][key], outs["cpu"][key]
            if dt == "float32":
                err, ok = _sddmm_err(got, ref, x, cot, SDDMM_HYPER_F)
            else:  # bf16 operands, f32 sums: within 2 bf16 ulps of the largest value
                err = float((got - ref).abs().max())
                ok = err <= 2 * 2.0**-8 * float(ref.abs().max())
            rec[f"{key}_max_abs_err"] = err
            if not ok:
                fail(f"sddmm: hypercube {dt} {key} disagrees with the CPU: max abs err {err}")
        adj = outs[DEVICE]["adj"]
        xc, cc = x.to(DEVICE), cot.to(DEVICE)
        xw = xc.clone().requires_grad_(True)

        def hstep(eg):
            def run():
                y = hypercube.propagate_hyper_affine(adj, xw, 0.75, 0.125, edge_grads=eg)
                y.backward(cc)
            return run

        rec["fwd_bwd_ms"] = _events_ms(torch, hstep(False), 20)
        rec["fwd_bwd_edge_grads_ms"] = _events_ms(torch, hstep(True), 20)
        rec["sddmm_ms"] = _events_ms(
            torch, lambda: hypercube._sddmm_hyper(cc.view(adj.feature_shape + (-1,)),
                                                  xc.view(adj.feature_shape + (-1,)), 0.75),
            20)
        rec["sddmm_share_of_backward"] = 1.0 - rec["fwd_bwd_ms"] / rec["fwd_bwd_edge_grads_ms"]
        records[f"hypercube_{dt}"] = rec
        del outs, adj, xc, cc, xw
        torch.cuda.empty_cache()
    emit("sddmm", **records)
    return counts


# -----------------------------------------------------------------------------
# Phase 20: levels trained over node shards
# -----------------------------------------------------------------------------

DIST_DIMS = (256, 128, 64)
DIST_EPOCHS = 5
DIST_WORLD = 2
# The sharded runs of the distributed phase's spawn: node shards in three
# modes, and 1 node shard x 2 feature shards ("feat_" kinds) in two, at
# n = 1..FEAT_N.
DIST_KINDS = ("hypercube", "halo", "gspmd", "feat_hypercube", "feat_gspmd")
FEAT_N = 3
# The feature-sharded runs are held against one device with each level
# starting from seeded rows on both sides (``_decoupled_levels``): coupled,
# the 3-level cascade of this configuration parts at level 2 on rounding
# alone (Adam's normalised step on a gradient that is a cancellation
# residue), so that the one-device run against itself, its ELL products
# summed with fmaf (the kernels) or with a multiply and an add (the plain
# version), reads 1.9e-3 at level 2 and 0.0619 in the exported embeddings,
# past DIST_EMBED_ATOL (PERF.md §6).  --plant-faults reads the coupled runs
# and that control too.
FEAT_KINDS = ("feat_hypercube", "feat_gspmd")
# A sharded run against the one-device run from the same initial parameters.
# The first level's first loss (before any update) within DIST_FIRST_RTOL;
# every other loss and the exported embeddings within the looser bounds:
# float32 sums in another order (a halo row's local and halo parts) compound
# over four cascaded levels of five Adam steps, and Adam moves an element
# whose gradient is a cancellation residue by a share of lr whatever the
# residue's size.  Measured at most 3.5e-3 and 8.9e-3 (halo mode on two
# ranks, PERF.md); a shard laid out wrong is off by tens of percent.
DIST_FIRST_RTOL = 1e-4
DIST_LOSS_RTOL = 2e-2
DIST_EMBED_ATOL = 5e-2


def _kind(kind: str):
    """(mode, feature shards, levels) of a sharded run's kind."""
    if kind.startswith("feat_"):
        return kind[len("feat_"):], 2, FEAT_N
    return kind, 1, 4


def _dist_config(kind: str, ws, out: str):
    """The distributed phase's configuration: ``ws`` ranks of ``kind``
    (``_kind``), or (``ws`` None) the one-device run on the matching
    format."""
    from protgram_directgcn_torch.config import Config

    mode, feats, n_max = _kind(kind)
    cfg = Config().apply_overrides({
        "graph_builder.ngram_max_n": n_max, "gcn.hidden_layer_dims": list(DIST_DIMS),
        "gcn.epochs_per_level": DIST_EPOCHS, "gcn.dropout_rate": 0.0,
        "gcn.default_task_type": "closest_aa", "gcn.apply_pca": False,
        "gcn.run_sanity_check_ppi": False, "id_mapping_mode": "none",
        "gcn.checkpoint_every_epochs": 0, "gcn.use_cluster_training": False})
    cfg.paths.base_output_dir = type(cfg.paths.base_output_dir)(out)
    if ws is not None:
        cfg.parallel.mesh_nodes = ws // feats
        cfg.parallel.mesh_feats = feats
        cfg.parallel.mode = mode
    else:  # "auto" takes the hypercube where hypercube mode does (alpha^n <= 4N)
        cfg.gcn.spmm_mode = "auto" if mode == "hypercube" else "ell"
    return cfg


class _LevelCache:
    """While active, in this process: each graph file loaded once, each
    level's three normalised matrices computed once and its labels drawn
    once (all deterministic), however many of the distributed phase's runs
    read them; the host work each run repeats is its own (operators,
    features, training, pooling)."""

    def __enter__(self):
        from protgram_directgcn_torch.graph.structure import NgramGraph
        from protgram_directgcn_torch.pipeline import trainer as trainer_mod

        self.mod, self.cls = trainer_mod, NgramGraph
        self.saved = (trainer_mod.load_graph, trainer_mod.generate_labels,
                      {k: getattr(NgramGraph, k)
                       for k in ("mathcal_a_in", "mathcal_a_out", "undirected_norm")})
        real_load, real_labels, methods = self.saved
        graphs, memo = {}, {}

        def load(path):
            key = os.path.abspath(str(path))
            if key not in graphs:
                graphs[key] = real_load(path)
            return graphs[key]

        def labels(graph, *args):
            key = ("labels", id(graph), args)
            if key not in memo:
                memo[key] = real_labels(graph, *args)
            return memo[key]

        def cached(name, real):
            def method(graph):
                key = (name, id(graph))
                if key not in memo:
                    memo[key] = real(graph)
                return memo[key]
            return method

        trainer_mod.load_graph, trainer_mod.generate_labels = load, labels
        for name, real in methods.items():
            setattr(NgramGraph, name, cached(name, real))
        return self

    def __exit__(self, *exc):
        self.mod.load_graph, self.mod.generate_labels, methods = self.saved
        for name, real in methods.items():
            setattr(self.cls, name, real)


@contextlib.contextmanager
def _no_decoder_dropout():
    """While active, dropout 0 in the decoder too (the trainer's model config
    has no knob for it): a sharded run draws its masks per rank."""
    from protgram_directgcn_torch.models import directgcn
    from protgram_directgcn_torch.pipeline import trainer

    trainer.DirectGCNConfig = lambda **kw: directgcn.DirectGCNConfig(**kw, decoder_dropout=0.0)
    try:
        yield
    finally:
        trainer.DirectGCNConfig = directgcn.DirectGCNConfig


def _probe_backend(torch, device, report) -> None:
    """Whether the group's backend takes tensors on ``device`` for
    ``all_to_all_single``, ``all_reduce`` and ``batch_isend_irecv`` (a ring
    step), called natively: "ok" or the error's first line, passed to
    ``report(answers)`` after each answer, so that what was learnt outlives
    an abort.  ``batch_isend_irecv`` last: a backend that mishandles it may
    abort the process instead of raising (gloo does, on CUDA tensors)."""
    import torch.distributed as dist

    out = {}
    ws, rk = dist.get_world_size(), dist.get_rank()

    def attempt(name, fn):
        try:
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out[name] = "ok"
        except Exception as exc:  # the probe's answer, not a failure
            out[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0] if str(exc) else ''}"
        report(dict(out))

    def a2a():
        send = torch.arange(ws * 4, dtype=torch.float32, device=device) + 100 * rk
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        want = torch.cat([torch.arange(rk * 4, rk * 4 + 4, dtype=torch.float32) + 100 * q
                          for q in range(ws)])
        if not torch.equal(recv.cpu(), want):
            raise RuntimeError("all_to_all_single delivered wrong data")

    def reduce():
        t = torch.full((8,), float(rk + 1), device=device)
        dist.all_reduce(t)
        if not torch.equal(t.cpu(), torch.full((8,), ws * (ws + 1) / 2)):
            raise RuntimeError("all_reduce delivered wrong data")

    def ring():
        send = torch.full((4,), float(rk), device=device)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, (rk + 1) % ws),
               dist.P2POp(dist.irecv, recv, (rk - 1) % ws)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        if not torch.equal(recv.cpu(), torch.full((4,), float((rk - 1) % ws))):
            raise RuntimeError("batch_isend_irecv delivered wrong data")

    attempt("all_to_all_single", a2a)
    attempt("all_reduce", reduce)
    attempt("batch_isend_irecv", ring)


@contextlib.contextmanager
def _planted(fault):
    """While active, in this process, the named fault of ``--plant-faults``
    (None: none): ``halo_zero_recv`` zeroes what a halo exchange delivers;
    ``hyper_gc_shift`` shifts the gc block a key shard's K2 reads by one key;
    ``slab_shift`` gives each rank's node rows the parameters of the row
    before (its slab shifted by one); ``gspmd_row_shift`` shifts the ELL
    tables' rows by one, so that each rank's row block starts a row late;
    ``feat_cols`` gives feature rank 1 rank 0's columns of every layer's
    ``w_main_in``."""
    from protgram_directgcn_torch.ops import hyper_kernels as hk
    from protgram_directgcn_torch.parallel import halo, mesh

    if fault is None:
        yield
        return
    real_ring, real_k2, real_shard = halo._ring_exchange, hk.k2, mesh.shard_model_params
    real_rows = mesh.build_row_shard_tables

    def k2(*a, x_gc=None, **kw):
        return real_k2(*a, x_gc=None if x_gc is None else x_gc.roll(1, 0), **kw)

    def row_shift(*a, **kw):
        tables = real_rows(*a, **kw)
        return {k: (v if k == "rows_per_shard" else v[list(range(1, len(v))) + [0]])
                for k, v in tables.items()}

    def feat_cols(params, rows, n, feat=None):
        out = real_shard(params, rows, n, feat)
        if feat is not None and feat.rank == 1:
            first = mesh.FeatShard(feat.shards, 0, feat.group)
            for lp, cut in zip(params["layers"], out["layers"]):
                cut["w_main_in"] = mesh._feat_slice(lp["w_main_in"], 1, first)
        return out

    mod, name, fn = {
        "halo_zero_recv": (halo, "_ring_exchange", lambda x, part: real_ring(x, part).zero_()),
        "hyper_gc_shift": (hk, "k2", k2),
        "slab_shift": (mesh, "shard_model_params",
                       lambda params, rows, n, feat=None: real_shard(params, rows.roll(1), n,
                                                                     feat)),
        "gspmd_row_shift": (mesh, "build_row_shard_tables", row_shift),
        "feat_cols": (mesh, "shard_model_params", feat_cols),
    }[fault]
    real = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, real)


@contextlib.contextmanager
def _kernel_widths(out: dict):
    """While active, ``out[kernel]`` collects the widths F of the K1 and ELL
    launches and ``out["ell_plain"]`` counts the plain ELL version's calls."""
    from protgram_directgcn_torch.ops import ell_kernels as ek, hyper_kernels as hk

    real = [(hk, "k1", 1), (ek, "ell_resident", 2), (ek, "ell_hbm", 2), (ek, "ell_plain", 2)]

    def recording(mod, name, pos):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            f = int(a[pos].shape[-1])
            if name == "ell_plain":
                out["ell_plain"] = out.get("ell_plain", 0) + 1
            elif f not in out.setdefault(name, []):
                out[name].append(f)
            return fn(*a, **kw)
        return wrapped

    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in real]
    for mod, name, pos in real:
        setattr(mod, name, recording(mod, name, pos))
    try:
        yield out
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _sharded_run(torch, kind: str, ws: int, graphs_dir: str, out: str, fasta: str,
                 device: str) -> dict:
    """One ``HierarchicalTrainer.run`` over the levels on this rank's shard:
    level stats, launches, the kernels' widths, exchange counts and the
    exported file (rank 0)."""
    from protgram_directgcn_torch.ops import ell_kernels as ek, hyper_kernels as hk
    from protgram_directgcn_torch.parallel import distributed as comm
    from protgram_directgcn_torch.pipeline.trainer import HierarchicalTrainer

    hk.reset_launches()
    ek.reset_launches()
    comm.reset_exchange_stats()
    trainer = HierarchicalTrainer(_dist_config(kind, ws, out), device=device)
    t0 = time.monotonic()
    with _kernel_widths({}) as widths:
        path = trainer.run(fasta, graphs_dir, os.path.join(out, "gcn"))
    if device == "cuda":
        torch.cuda.synchronize()
    levels = {n: {k: st[k] for k in ("route", "losses", "train_seconds", "epochs", "launches",
                                      "eval_launches", "operator_seconds", "eval_seconds",
                                      "rank_nodes", "feat_shards", "peak_device_bytes",
                                      "epilogue")
                  if k in st}
              for n, st in trainer.level_stats.items()}
    return {"seconds": time.monotonic() - t0, "levels": levels, "path": path,
            "launches": {**hk.launch_counts(), **ek.launch_counts()}, "widths": widths,
            "exchange": dict(comm.EXCHANGE), "backend": comm.backend(), "world_size": comm.world_size()}


def _dist_rank(rank: int, ws: int, store: str, outdir: str, what: str, args: dict) -> None:
    """A rank process of the distributed phase: joins a gloo group on the
    card and writes its answers to ``{outdir}/{what}_r{rank}.json`` (the
    probe after each answer, so that an abort leaves what was learnt).
    ``args``: the ``kinds`` to train (``DIST_KINDS`` by default), a ``fault`` to plant
    (``_planted``; none by default) and ``decoupled``: the kinds whose levels
    are decoupled (``_decoupled_levels``; ``FEAT_KINDS`` by default, True:
    every kind)."""
    import torch

    path = os.path.join(outdir, f"{what}_r{rank}.json")

    def write(obj):
        with open(path + ".tmp", "w") as fh:
            json.dump(obj, fh)
        os.replace(path + ".tmp", path)

    try:
        from protgram_directgcn_torch.ops import ell_kernels as ek, hyper_kernels as hk
        from protgram_directgcn_torch.parallel import distributed as comm

        device = args.get("device", "cuda")
        comm.initialize_distributed(init_method="file://" + store, world_size=ws, rank=rank,
                                    device=device, backend="gloo")
        if what == "probe":
            _probe_backend(torch, torch.device(device), report=write)
            return
        if what == "scaling":
            write({"ok": True, **_scaling_points(torch, [1, ws], device)})
            return
        if device == "cuda":
            hk.build()
            ek.build()
        comm.TIME_EXCHANGES = bool(args.get("time_exchanges"))
        fault = args.get("fault")
        decoupled = args.get("decoupled", FEAT_KINDS)
        runs = {}
        with _no_decoder_dropout(), _LevelCache(), _planted(fault):
            for kind in args.get("kinds", DIST_KINDS):
                with _decoupled_levels(decoupled is True or kind in decoupled):
                    runs[kind] = _sharded_run(torch, kind, ws, args["graphs_dir"],
                                              os.path.join(args["out"], f"{kind}_ws{ws}_{what}"),
                                              args["fasta"], device)
        write({"ok": True, "runs": runs})
    except Exception as exc:
        import traceback

        write({"ok": False, "error": f"{exc}\n{traceback.format_exc()}"})
        raise


def _start_ranks(ws: int, what: str, args: dict, timeout: float):
    """Start ``_dist_rank`` in ``ws`` spawned processes; ``_join_ranks``
    collects them."""
    import multiprocessing as mp

    outdir = tempfile.mkdtemp(prefix=f"protgram_{what}_")
    store = os.path.join(outdir, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dist_rank, args=(r, ws, store, outdir, what, args))
             for r in range(ws)]
    for p in procs:
        p.start()
    return procs, outdir, what, time.monotonic() + timeout


def _spawn_ranks(ws: int, what: str, args: dict, timeout: float) -> dict:
    return _join_ranks(_start_ranks(ws, what, args, timeout))


def _join_ranks(handle) -> dict:
    """Each rank's answers and exit code.  Every process is joined, or killed
    at the deadline."""
    procs, outdir, what, deadline = handle
    for p in procs:
        p.join(max(0.1, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    answers = {}
    for r, p in enumerate(procs):
        path = os.path.join(outdir, f"{what}_r{r}.json")
        answers[r] = {"exitcode": p.exitcode,
                      "answer": json.load(open(path)) if os.path.exists(path) else None}
    return answers


@contextlib.contextmanager
def _padded_init(kind: str, ws: int):
    """While active, the trainer's initial parameters of each level are the
    ``ws``-rank run's of ``kind``: the whole level's draws over the
    shard-padded node space, cut to the level's own node space (the padding
    rows of a sharded run touch no real node).  A one-device run, or a
    one-shard run, then starts where the ``ws``-rank run starts."""
    import dataclasses

    from protgram_directgcn_torch.ops.hypercube import vocab_char_codes
    from protgram_directgcn_torch.pipeline import trainer as trainer_mod

    mode, feats, _ = _kind(kind)
    ws = ws // feats  # node shards

    real_init = trainer_mod.init_directgcn_params
    graph_of = {}

    def padded_init(gen, cfg, device):
        n = cfg.n_gram_len
        graph = graph_of[n]
        _, a = vocab_char_codes(graph.vocab)
        hyper = (mode == "hypercube" and n >= 2
                 and a**n <= trainer_mod._HYPERCUBE_MAX_RATIO * graph.num_nodes)
        if hyper:
            g = a ** (n - 1)
            gp = -(-g // ws) * ws
            total = a * gp
        else:
            total = -(-graph.num_nodes // ws) * ws
        params = real_init(gen, dataclasses.replace(cfg, num_nodes=total), device)
        for lp in params["layers"]:
            for k in trainer_mod._NODE_PARAM_NAMES:
                v = lp.get(k)
                if v is None or v.dim() < 1 or v.shape[0] != total:
                    continue
                if hyper:
                    v = v.reshape((a, gp) + tuple(v.shape[1:]))[:, :g].reshape(
                        (a * g,) + tuple(v.shape[1:]))
                else:
                    v = v[: cfg.num_nodes]
                lp[k] = v.contiguous()
        return params

    real_train = trainer_mod.HierarchicalTrainer.train_level

    def train_level(self, graph, *a, **kw):
        graph_of[graph.n] = graph
        return real_train(self, graph, *a, **kw)

    trainer_mod.init_directgcn_params = padded_init
    trainer_mod.HierarchicalTrainer.train_level = train_level
    try:
        yield
    finally:
        trainer_mod.init_directgcn_params = real_init
        trainer_mod.HierarchicalTrainer.train_level = real_train


def _reference_run(torch, kind: str, ws: int, graphs_dir: str, out: str, fasta: str) -> dict:
    """The one-device run of ``kind``'s levels from the ``ws``-rank run's
    initial parameters (``_padded_init``)."""
    from protgram_directgcn_torch.pipeline.trainer import HierarchicalTrainer

    with _padded_init(kind, ws):
        trainer = HierarchicalTrainer(_dist_config(kind, None, out), device=DEVICE)
        path = trainer.run(fasta, graphs_dir, os.path.join(out, "gcn"))
    return {"path": path, "levels": {n: {"route": st["route"], "losses": st["losses"]}
                                     for n, st in trainer.level_stats.items()}}


def _gaps(run: dict, ref: dict, what: str) -> dict:
    """Losses of every level and the exported embeddings of a run against
    the one-device run: the first level's first loss, each level's first
    loss and the worst loss (relative), and the embeddings (max abs).  Fails
    only where the two cannot be compared."""
    import numpy as np

    from protgram_directgcn_torch.utils.io import read_embeddings

    worst_loss, by_level = 0.0, {}
    for n, lv in sorted(ref["levels"].items()):
        got = np.asarray(run["levels"][str(n)]["losses"] if str(n) in run["levels"]
                         else run["levels"][n]["losses"])
        want = np.asarray(lv["losses"])
        if got.shape != want.shape:
            fail(f"{what}: level n={n} losses {got.tolist()} against {want.tolist()}")
        rel = np.abs(got - want) / np.abs(want)
        rel = np.where(np.isfinite(rel), rel, np.inf)
        by_level[str(n)] = float(rel[0])
        worst_loss = max(worst_loss, float(rel.max()))
    a, b = read_embeddings(run["path"]), read_embeddings(ref["path"])
    if sorted(a) != sorted(b) or len(a) != N_SEQS:
        fail(f"{what}: exported {len(a)} proteins, the one-device run {len(b)}")
    per_protein = np.array([float(np.nan_to_num(np.abs(a[k].astype(np.float32) - b[k]),
                                                nan=np.inf).max()) for k in b])
    return {"first_loss_rel_err": by_level[min(by_level, key=int)],
            "first_loss_rel_err_by_level": by_level, "loss_max_rel_err": worst_loss,
            "embeddings_max_abs_err": float(per_protein.max()),
            # How the gap spreads over the proteins (read, not bounded).
            "embeddings_p99_abs_err": float(np.quantile(per_protein, 0.99)),
            "proteins_past_1e-3": int((per_protein > 1e-3).sum())}


def _within_bounds(gaps: dict) -> bool:
    return (gaps["first_loss_rel_err"] <= DIST_FIRST_RTOL
            and gaps["loss_max_rel_err"] <= DIST_LOSS_RTOL
            and gaps["embeddings_max_abs_err"] <= DIST_EMBED_ATOL)


def _compare_runs(run: dict, ref: dict, what: str) -> dict:
    """``_gaps``, failing past the phase's bounds."""
    gaps = _gaps(run, ref, what)
    if not _within_bounds(gaps):
        fail(f"{what}: against the one-device run, first loss rel err "
             f"{gaps['first_loss_rel_err']} (tolerance {DIST_FIRST_RTOL}), loss rel err "
             f"{gaps['loss_max_rel_err']} (tolerance {DIST_LOSS_RTOL}), embeddings max abs "
             f"err {gaps['embeddings_max_abs_err']} (tolerance {DIST_EMBED_ATOL})")
    return {**gaps, "first_loss_rtol": DIST_FIRST_RTOL, "loss_rtol": DIST_LOSS_RTOL,
            "embeddings_atol": DIST_EMBED_ATOL}


def _path_counts(runs) -> dict:
    """K1/K2/ELL launches summed over runs (each rank's own counts)."""
    total = {}
    for run in runs:
        for name, per_dir in run["launches"].items():
            cur = total.setdefault(name, {"fwd": 0, "bwd": 0})
            for d, v in per_dir.items():
                cur[d] += v
    return total


def _phase_of(kind: str) -> str:
    mode, feats, _ = _kind(kind)
    return "feat" if feats > 1 else ("gspmd" if mode == "gspmd" else "distributed")


def _want_kernels(kind: str, n: int, takes_hyper: bool):
    """(route, kernel groups each launched both ways) of a sharded level."""
    mode = _kind(kind)[0]
    if mode == "hypercube" and takes_hyper:
        return "hyper_shard", (("k1",), ("k2",))
    if mode == "gspmd":  # the gathered table's rows pick the regime
        return "gspmd", ((("ell_resident",) if n <= 3 else ("ell_hbm",)),)
    # A halo level's local and halo tables each take the kernel of their
    # rows' regime.
    return "halo", (("ell_resident", "ell_hbm"),)


def run_distributed(torch, graph_paths, workdir: str, fasta: str) -> dict:
    """Levels trained over shards, each held against the one-device run from
    the same initial parameters: n = 1..4 over node shards (phase
    ``distributed``: hypercube mode, n = 1 in halo mode, and halo mode;
    phase ``gspmd``: the row-sharded ELL) at world size 1 under NCCL in this
    process and at world size 2 under gloo in two spawned processes sharing
    the card, and n = 1..FEAT_N over 1 node shard x 2 feature shards (phase
    ``feat``: hypercube and gspmd modes) at world size 2; gloo's handling of
    CUDA tensors probed first.  Returns each phase's launches by kernel."""
    from protgram_directgcn_torch.graph.structure import load_graph
    from protgram_directgcn_torch.ops.hypercube import vocab_char_codes
    from protgram_directgcn_torch.parallel import distributed as comm

    graphs_dir = os.path.dirname(graph_paths[0])
    probe_handle = _start_ranks(DIST_WORLD, "probe", {"device": DEVICE}, timeout=120)
    # (b) World size 2 under gloo, two processes on the card, every kind in
    # turn, running beside the probe and while this process does (a) and
    # the references: their step and exchange times are read beside that
    # work.
    handle = _start_ranks(DIST_WORLD, "train",
                          {"graphs_dir": graphs_dir, "out": workdir, "fasta": fasta,
                           "time_exchanges": True, "device": DEVICE}, timeout=900)
    probe = _join_ranks(probe_handle)
    emit("distributed_probe", backend="gloo", device=DEVICE,
         ranks={str(r): v for r, v in probe.items()})
    # (a) World size 1 under NCCL (the card's backend), in this process, and
    # the one-device references, all from the world-size-2 runs' initial
    # parameters.
    store = os.path.join(tempfile.mkdtemp(prefix="protgram_nccl_"), "store")
    refs = {}
    with _no_decoder_dropout(), _LevelCache():
        comm.initialize_distributed(init_method="file://" + store, world_size=1, rank=0,
                                    device=DEVICE, backend="nccl" if DEVICE == "cuda" else "gloo")
        try:
            ws1 = {}
            for kind in ("hypercube", "halo", "gspmd"):
                with _padded_init(kind, DIST_WORLD):
                    ws1[kind] = _sharded_run(torch, kind, 1, graphs_dir,
                                             os.path.join(workdir, f"dist_{kind}_ws1"), fasta,
                                             DEVICE)
        finally:
            comm.dist.destroy_process_group()
        for kind in ("hypercube", "halo") + FEAT_KINDS:
            with _decoupled_levels(kind in FEAT_KINDS):
                refs[kind] = _reference_run(torch, kind, DIST_WORLD, graphs_dir,
                                            os.path.join(workdir, f"ref_{kind}"), fasta)
    # gspmd's one-device run is halo's: the same ELL operators from the same
    # padded initial parameters.
    refs["gspmd"] = refs["halo"]
    ranks = _join_ranks(handle)
    for r, v in ranks.items():
        if v["exitcode"] != 0 or not (v["answer"] or {}).get("ok"):
            fail(f"distributed: rank {r} of {DIST_WORLD} failed (exit {v['exitcode']}): "
                 f"{(v['answer'] or {}).get('error', 'no answer')}")
    ws2 = {r: v["answer"]["runs"] for r, v in ranks.items()}

    takes_hyper = {}  # the trainer's rule: n >= 2 and alpha^n <= 4x the vocabulary
    for path in graph_paths:
        graph = load_graph(path)
        _, a = vocab_char_codes(graph.vocab)
        takes_hyper[graph.n] = graph.n >= 2 and a**graph.n <= 4 * graph.num_nodes
    counts = {}
    for kind in DIST_KINDS:
        mode, feats, _ = _kind(kind)
        phase = _phase_of(kind)
        for ws, run in ([] if feats > 1 else [(1, ws1[kind])]) + [(DIST_WORLD, ws2[0][kind])]:
            cmp = _compare_runs(run, refs[kind], f"{kind} at world size {ws}")
            ranks_of = [run] if ws == 1 else [ws2[r][kind] for r in sorted(ws2)]
            for r, rr in enumerate(ranks_of):
                for n, lv in rr["levels"].items():
                    route, groups = _want_kernels(kind, int(n), takes_hyper[int(n)])
                    if lv["route"] != route or lv.get("feat_shards", 1) != feats:
                        fail(f"{phase}: {kind} level n={n} took {lv['route']} over "
                             f"{lv.get('feat_shards')} feature shards, not {route} over {feats}")
                    if feats > 1 and lv["epilogue"]["route"] != "plain":
                        fail(f"{phase}: {kind} level n={n}'s layer tails took the kernels on "
                             f"a feature shard: {lv['epilogue']}")
                    for names in groups:
                        for direction in ("fwd", "bwd"):
                            if sum(lv["launches"][k][direction] for k in names) <= 0:
                                fail(f"{phase}: {kind} ws={ws} rank {r} level n={n} never "
                                     f"launched {'/'.join(names)} ({direction}): "
                                     f"{lv['launches']}")
                if rr["widths"].get("ell_plain"):
                    fail(f"{phase}: {kind} ws={ws} rank {r} ran the plain ELL version "
                         f"{rr['widths']['ell_plain']} times")
            emit(phase, kind=kind, mode=mode, world_size=ws, node_shards=ws // feats,
                 feat_shards=feats, levels_decoupled=kind in FEAT_KINDS, backend=run["backend"],
                 concurrent_with=(None if ws == 1 else
                                  "this process's one-shard runs and one-device references"),
                 seconds=run["seconds"],
                 exchange={str(r): rr["exchange"] for r, rr in enumerate(ranks_of)},
                 widths={str(r): rr["widths"] for r, rr in enumerate(ranks_of)},
                 step_seconds={n: lv["train_seconds"] / max(1, lv["epochs"])
                               for n, lv in run["levels"].items()},
                 levels=run["levels"], launches=_path_counts(ranks_of), **cmp)
            total = counts.setdefault(phase, {})
            for name, per_dir in _path_counts(ranks_of).items():
                cur = total.setdefault(name, {"fwd": 0, "bwd": 0})
                for d, v in per_dir.items():
                    cur[d] += v
    return counts


@contextlib.contextmanager
def _reversed_slots():
    """While active, every ELL operator ``spmm.build_ell`` builds lists each
    row's slots (both orientations) in reverse order: the same products,
    summed in another order."""
    from protgram_directgcn_torch.ops import spmm

    real = spmm.build_ell

    def build_ell(*args, **kw):
        adj = real(*args, **kw)
        return spmm.EllAdj(*(t.flip(1).contiguous() for t in (adj.idx, adj.w, adj.idx_t, adj.w_t)))

    spmm.build_ell = build_ell
    try:
        yield
    finally:
        spmm.build_ell = real


@contextlib.contextmanager
def _decoupled_levels(on: bool = True):
    """While active (``on``), each level n >= 2 starts from seeded unit rows
    in place of level n - 1's embeddings, so that a level's gap to the
    one-device run is its own, not what the levels below carried up."""
    import numpy as np

    from protgram_directgcn_torch.pipeline.trainer import HierarchicalTrainer

    real = HierarchicalTrainer._initial_features

    def initial_features(self, graph, prev_vocab, prev_embeds, seed):
        if on and prev_embeds is not None and prev_embeds.size:
            rows = np.random.default_rng(graph.n).standard_normal(prev_embeds.shape)
            prev_embeds = (rows / np.linalg.norm(rows, axis=1, keepdims=True)).astype(np.float32)
        return real(self, graph, prev_vocab, prev_embeds, seed)

    HierarchicalTrainer._initial_features = initial_features
    try:
        yield
    finally:
        HierarchicalTrainer._initial_features = real


# (fault, kind) of --plant-faults: each a world-size-2 run of one kind.
DIST_FAULTS = (("halo_zero_recv", "halo"), ("hyper_gc_shift", "hypercube"),
               ("slab_shift", "halo"), ("gspmd_row_shift", "gspmd"),
               ("feat_cols", "feat_hypercube"))


@contextlib.contextmanager
def _plain_ell():
    """While active, in this process, ELL products on the card run the plain
    version (a multiply and an add a slot) in place of the kernels (fmaf)."""
    from protgram_directgcn_torch.ops import spmm

    real = spmm._on_card
    spmm._on_card = lambda t: False
    try:
        yield
    finally:
        spmm._on_card = real


def plant_faults(torch, graph_paths, workdir: str, fasta: str) -> bool:
    """The distributed phase's world-size-2 runs of every kind, sound (the
    feature-sharded kinds with their levels decoupled, as the phase runs
    them) and with each planted fault of ``DIST_FAULTS``, in spawned
    processes at once, held against the one-device references in this
    process, with a control: the one-device halo run with the ELL slots
    reversed; and, read but not bounded, the node-sharded kinds with their
    levels decoupled, the feature-sharded kinds coupled, and the one-device
    feature kinds' gspmd run with the plain ELL version on the card.  Emits
    each run's ``_gaps`` beside the bounds; True where every sound run and
    the control are within them and every fault is past them."""
    graphs_dir = os.path.dirname(graph_paths[0])
    base = {"graphs_dir": graphs_dir, "out": workdir, "fasta": fasta, "device": DEVICE}
    handles = {"sound": _start_ranks(DIST_WORLD, "sound", base, timeout=900),
               "decoupled": _start_ranks(DIST_WORLD, "decoupled",
                                         {**base, "decoupled": True,
                                          "kinds": ("hypercube", "halo")}, timeout=900),
               "coupled": _start_ranks(DIST_WORLD, "coupled",
                                       {**base, "decoupled": (), "kinds": FEAT_KINDS},
                                       timeout=900)}
    for fault, kind in DIST_FAULTS:
        handles[fault] = _start_ranks(DIST_WORLD, fault, {**base, "fault": fault,
                                                          "kinds": (kind,)}, timeout=900)
    refs = {}
    with _no_decoder_dropout(), _LevelCache():
        for decoupled in (False, True):
            with _decoupled_levels(decoupled):
                for kind in ("hypercube", "halo") + FEAT_KINDS:
                    refs[decoupled, kind] = _reference_run(
                        torch, kind, DIST_WORLD, graphs_dir,
                        os.path.join(workdir, f"ref_{kind}_{decoupled}"), fasta)
        with _reversed_slots():
            control = _reference_run(torch, "halo", DIST_WORLD, graphs_dir,
                                     os.path.join(workdir, "control_halo"), fasta)
        with _plain_ell():
            control_feat = _reference_run(torch, "feat_gspmd", DIST_WORLD, graphs_dir,
                                          os.path.join(workdir, "control_feat"), fasta)
    refs[False, "gspmd"] = refs[False, "halo"]  # the same ELL run
    readings = {"control_halo": _gaps(control, refs[False, "halo"], "control"),
                "control_feat_gspmd": _gaps(control_feat, refs[False, "feat_gspmd"],
                                            "feature control")}
    diagnostic = {"control_feat_gspmd"}
    for name, handle in handles.items():
        ranks = _join_ranks(handle)
        for r, v in ranks.items():
            if v["exitcode"] != 0 or not (v["answer"] or {}).get("ok"):
                fail(f"plant-faults: {name} rank {r} failed (exit {v['exitcode']}): "
                     f"{(v['answer'] or {}).get('error', 'no answer')}")
        for kind, run in ranks[0]["answer"]["runs"].items():
            decoupled = name == "decoupled" or (name != "coupled" and kind in FEAT_KINDS)
            key = f"{name}_{kind}"
            readings[key] = _gaps(run, refs[decoupled, kind], f"{name} {kind}")
            readings[key]["levels_decoupled"] = decoupled
            if name in ("decoupled", "coupled"):
                diagnostic.add(key)
    for key, gaps in readings.items():
        gaps["within_bounds"] = _within_bounds(gaps)
        gaps["bounded"] = key not in diagnostic
    ok = all(g["within_bounds"] == (not any(key.startswith(f) for f, _ in DIST_FAULTS))
             for key, g in readings.items() if g["bounded"])
    emit("distributed_bounds", world_size=DIST_WORLD, bounds={
        "first_loss_rtol": DIST_FIRST_RTOL, "loss_rtol": DIST_LOSS_RTOL,
        "embeddings_atol": DIST_EMBED_ATOL}, readings=readings, bounds_separate=ok)
    return ok


# -----------------------------------------------------------------------------
# Doctor, transformer stage, scaling harness
# -----------------------------------------------------------------------------


def start_doctor():
    """``python -m protgram_directgcn_torch.doctor`` started in a process of
    its own (the kernel builds it checks are phase 0's, cached);
    ``check_doctor`` waits for it; a run that fails before kills it."""
    import atexit

    proc = subprocess.Popen([sys.executable, "-m", "protgram_directgcn_torch.doctor"],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return time.monotonic(), proc


def check_doctor(handle) -> None:
    """Every check of the doctor ``[ok]``, and its exit 0."""
    t0, proc = handle
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    checks = [ln for ln in lines if ln.startswith("[")]
    if proc.returncode != 0 or len(checks) < 8 or not all(c.startswith("[ok]") for c in checks):
        fail(f"doctor: exit {proc.returncode}: {lines} {err[-2000:]}")
    emit("doctor", seconds=time.monotonic() - t0, lines=lines)


def run_transformer(torch, fasta: str, workdir: str) -> None:
    """``--stages transformer`` on the main path's FASTA and ``--out``: no
    checkpoint loads on this machine, so the stage writes the seeded
    residue-projection fallback; one finite 64-wide vector a protein, equal
    to the same vectors computed in this process on the CPU."""
    import numpy as np

    from protgram_directgcn_torch.config import Config
    from protgram_directgcn_torch.pipeline.transformer import residue_projection_embeddings
    from protgram_directgcn_torch.utils.io import parse_fasta, read_embeddings

    argv = ["--fasta", fasta, "--out", os.path.join(workdir, "out"), "--stages", "transformer",
            "--device", DEVICE]
    result, seconds = _drive(torch, argv)
    paths = result["transformer_paths"]
    if not result["transformer"].fallback or len(paths) != 1:
        fail(f"transformer: files {paths}, fallback {result['transformer'].fallback}")
    got = read_embeddings(paths[0])
    vecs = np.stack(list(got.values())).astype(np.float32)
    if len(got) != N_SEQS or vecs.shape[1] != 64 or not np.isfinite(vecs).all():
        fail(f"transformer: {len(got)} proteins, shape {vecs.shape}")
    tcfg = Config()
    cpu = residue_projection_embeddings(list(parse_fasta(fasta)), tcfg.transformer.fallback_dim,
                                        tcfg.random_state, tcfg.transformer.pooling_strategy)
    if sorted(cpu) != sorted(got) or any(not np.array_equal(got[k], cpu[k]) for k in cpu):
        fail("transformer: the card's run differs from the CPU's")
    emit("transformer", wall_seconds=seconds, stage_seconds=result["seconds"]["transformer"],
         proteins=len(got), dim=int(vecs.shape[1]), fallback=True,
         files=[os.path.basename(p) for p in paths], equal_to_cpu=True)


SCALE_NODES = 4096  # weak scaling: the ngram workload's nodes a shard
SCALE_KEYS = 512  # the hypercube workload's keys a shard
SCALE_FEAT = 32  # the fixed-graph curves' width (the JAX package's default)


def _scaling_points(torch, counts, device) -> dict:
    """The two weak-scaling reports at shard counts ``counts``."""
    from protgram_directgcn_torch.bench import scaling

    return {"weak": [p.__dict__ for p in scaling.weak_scaling_report(
                nodes_per_shard=SCALE_NODES, shard_counts=counts, device=device)],
            "hyper": [p.__dict__ for p in scaling.hyper_shard_scaling_report(
                keys_per_shard=SCALE_KEYS, shard_counts=counts, device=device)]}


def run_scaling(torch, graph_path: str) -> None:
    """The scaling harness (``bench/scaling.py``): ``weak_scaling_report``
    (ngram, SCALE_NODES nodes a shard) and ``hyper_shard_scaling_report``
    (SCALE_KEYS keys a shard) at D = 1 and 2 under gloo in two spawned
    processes on the card, then at D = 1 under NCCL in this process with
    ``fivegram_scaling_report``'s five curves on the level saved at
    ``graph_path`` (the ell path's n = 4 level); each curve's ms a step and
    edges a second."""
    from protgram_directgcn_torch.bench import scaling
    from protgram_directgcn_torch.parallel import distributed as comm

    t0 = time.monotonic()
    ranks = _spawn_ranks(DIST_WORLD, "scaling", {"device": DEVICE}, timeout=300)
    for r, v in ranks.items():
        if v["exitcode"] != 0 or not (v["answer"] or {}).get("ok"):
            fail(f"scaling: rank {r} failed (exit {v['exitcode']}): "
                 f"{(v['answer'] or {}).get('error', 'no answer')}")
    gloo = ranks[0]["answer"]
    gloo_seconds = time.monotonic() - t0
    store = os.path.join(tempfile.mkdtemp(prefix="protgram_scaling_"), "store")
    comm.initialize_distributed(init_method="file://" + store, world_size=1, rank=0,
                                device=DEVICE, backend="nccl")
    try:
        nccl = _scaling_points(torch, [1], DEVICE)
        t5 = time.monotonic()
        fixed = scaling.fivegram_scaling_report(feat_dim=SCALE_FEAT, shard_counts=[1],
                                                graph_path=graph_path, device=DEVICE)
        fixed_seconds = time.monotonic() - t5
    finally:
        comm.dist.destroy_process_group()
    points = {f"{name}_{backend}": pts for backend, out in (("gloo", gloo), ("nccl", nccl))
              for name, pts in out.items() if name in ("weak", "hyper")}
    for key, pts in list(points.items()) + [(c, v) for c, v in fixed.items() if c != "graph"]:
        if not pts or not all(_finite([p[k] for k in ("seconds_per_step", "edges_per_s",
                                                     "efficiency")]) for p in pts):
            fail(f"scaling: {key} points {pts}")
    curves = {c: {"ms_per_step": v[0]["seconds_per_step"] * 1e3,
                  "edges_per_s": v[0]["edges_per_s"]}
              for c, v in fixed.items() if c != "graph"}
    emit("scaling", note="D = 2 runs two ranks on one card under gloo, whose exchanges pass "
                         "through host memory: a path check, no scaling result",
         points=points, fixed_graph=fixed["graph"], fixed_graph_file=os.path.basename(graph_path),
         fixed_curves=curves, gloo_seconds=gloo_seconds, fixed_seconds=fixed_seconds,
         seconds=time.monotonic() - t0)


def _kernels_line(records, counts, ell_records, ell_edges, ell_counts, retile_records,
                  tier_counts, cluster_counts, bench_counts, bench_by_v, bench_ell):
    """One entry per kernel.  K1/K2: their numbers at the main path's widest
    shape, the 5-gram shape's, and the worst error of each type over every
    shape.  ELL: their numbers at F = 256 on their level's 𝒜_in, every F
    under ``by_f``, the transpose orientation, the other operators and the
    edge cases; their launches on the ell path, and on the cluster path
    under ``launches_cluster_path``.  Retile: their numbers in bf16 at the 5-gram
    carry (pack: the 128-padded input, which has a one-call library
    equivalent; the exact-width input under ``exact_width``), float32 under
    ``by_dtype``, and their launches on the tier path."""
    main_rec = next(r for r in records if r["shape"] == [21, 441, 256]
                    and r["dtype"] == "float32" and not r["misaligned"])
    large_recs = [r for r in records if r["shape"][:2] == list(LARGE_SHAPE[:2])]
    large_rec = next(r for r in large_recs if r["shape"] == list(LARGE_SHAPE))
    kernels = []
    for name in ("hyper_k1", "hyper_k2"):
        k = name[-2:]
        worst = {}
        for r in records:
            cur = worst.get(r["dtype"])
            if cur is None or r[f"{k}_max_abs_err"] > cur["max_abs_err"]:
                worst[r["dtype"]] = {"max_abs_err": r[f"{k}_max_abs_err"], "shape": r["shape"]}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": counts[k]["fwd"] + counts[k]["bwd"],
            "launches_fwd": counts[k]["fwd"], "launches_bwd": counts[k]["bwd"],
            "shape": main_rec["shape"], "dtype": main_rec["dtype"],
            "max_abs_err": main_rec[f"{k}_max_abs_err"],
            "tolerance": "float32: rtol %g, atol %g" % F32_TOL,
            "ms": main_rec[f"{k}_ms"], "plain_ms": main_rec[f"{k}_plain_ms"],
            "bound_ms": main_rec[f"{k}_bound_ms"], "bound_by": main_rec[f"{k}_bound_by"],
            "library_ms": main_rec[f"{k}_library_ms"],
            "wrapper_ms": main_rec[f"{k}_wrapper_ms"],
            "at_5gram": {key: large_rec[f"{k}_{key}"] for key in (
                "ms", "plain_ms", "library_ms", "wrapper_ms", "bound_ms", "max_abs_err")}
            | {"shape": large_rec["shape"], "dtype": large_rec["dtype"],
               "by_f": {str(r["shape"][2]): {key: r[f"{k}_{key}"] for key in (
                   "ms", "library_ms", "wrapper_ms", "bound_ms", "max_abs_err")}
                   for r in large_recs}},
            "other_shapes": [{"shape": r["shape"], "dtype": r["dtype"],
                              "misaligned": r["misaligned"],
                              "launches_by_v": r["launches_by_v"][k]}
                             | {key: r[f"{k}_{key}"] for key in (
                                 "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
                             for r in records if r["misaligned"] or r["shape"][0] != 21],
            "worst_max_abs_err_by_dtype": worst,
        })
    timed = ("ms", "plain_ms", "library_ms", "wrapper_ms", "bound_ms", "gathered_bytes",
             "gathered_tb_per_s")
    for name in ("ell_resident", "ell_hbm"):
        recs = [r for r in ell_records if r["name"] == name]
        a_in = [r for r in recs if r["matrix"] == "mathcal_a_in"]
        top = next(r for r in a_in if r["f"] == max(ELL_WIDTHS))
        errs = ("fwd_max_abs_err", "autograd_fwd_max_abs_err", "bwd_max_abs_err")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": ell_counts[name]["fwd"] + ell_counts[name]["bwd"],
            "launches_fwd": ell_counts[name]["fwd"], "launches_bwd": ell_counts[name]["bwd"],
            "launches_on": "ell path",
            "launches_cluster_path": cluster_counts[name],
            "launches_benchmark_path": bench_counts[name],
            "launches_benchmark_by_v": {str(v): n for v, n in bench_by_v[name].items()},
            "shape": {key: top[key] for key in ("level", "matrix", "n_out", "k", "n_in", "k_t",
                                                "nnz", "f")},
            "dtype": "float32", "max_abs_err": max(top[e] for e in errs),
            "tolerance": "rtol 1e-5, atol 1e-6 * max|input| * K",
            **{key: top[key] for key in timed}, "bound_by": top["bound_by"],
            "transpose": top["transpose"],
            "by_f": {str(r["f"]): {key: r[key] for key in timed + errs} for r in a_in},
            "other_operators": {r["matrix"]: {key: r[key] for key in timed + errs}
                                | {"transpose": r["transpose"]}
                                for r in recs if r["matrix"] != "mathcal_a_in"},
            "edge_cases": {r["case"]: {key: r[key] for key in r if key not in (
                "case", "name", "plan")} for r in ell_edges if r["name"] == name},
            "narrow_widths": {str(r["f"]): {key: r[key] for key in timed + errs}
                              | {key: r[key] for key in ("dataset", "operator", "n_out", "k")}
                              for r in bench_ell if r["name"] == name},
        })
    library_calls = {"retile_unpack": "F.pad(t.view(A, GP*k, f), (0, 128 - f))",
                     "retile_pack": "t[..., :f].reshape(A, GP, 128) (128-padded input)"}
    for name, key in (("retile_unpack", "unpack"), ("retile_pack", "pack_padded")):
        kernel = key.split("_")[0]
        by_dtype = {}
        for r in retile_records:
            errs = [v for e, v in r.items() if e.startswith(kernel) and e.endswith("_max_abs_err")]
            by_dtype[r["dtype"]] = {
                "ms": r[f"{key}_ms"], "plain_ms": r[f"{key}_plain_ms"],
                "library_ms": r[f"{key}_library_ms"], "wrapper_ms": r[f"{key}_wrapper_ms"],
                "bound_ms": r[f"{key}_bound_ms"], "max_abs_err": max(errs)}
            if kernel == "pack":
                by_dtype[r["dtype"]]["exact_width"] = {
                    e: r[f"pack_exact_{e}"] for e in ("ms", "plain_ms", "wrapper_ms", "bound_ms")
                } | {"library_ms": None}
        top = by_dtype["bfloat16"]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": tier_counts[kernel]["fwd"] + tier_counts[kernel]["bwd"],
            "launches_fwd": tier_counts[kernel]["fwd"], "launches_bwd": tier_counts[kernel]["bwd"],
            "launches_on": "tier path", "shape": retile_records[0]["carry"], "dtype": "bfloat16",
            "tolerance": "exact (bitwise equal)", "max_abs_err": top["max_abs_err"],
            **{k: top[k] for k in ("ms", "plain_ms", "library_ms", "wrapper_ms", "bound_ms")},
            "bound_by": "bytes", "library_call": library_calls[name], "by_dtype": by_dtype,
        })
    return kernels


def _ell_occupancy(ek) -> dict:
    """Blocks an SM holds of the ELL plans at the n = 4 level's shape (F = 256
    at 16 bytes a thread, F = 37 at one element) and the n = 3 level's
    (F = 256, the small-table regime)."""
    out = {}
    for key, n, f, aligned in (("n4_f256", 167_325, 256, True), ("n4_f37", 167_325, 37, True),
                               ("n3_f256", 8_401, 256, True)):
        plan = ek.launch_plan(n, 44, f, aligned, n)
        blocks = ek.occupancy(plan)
        out[key] = {"plan": plan._asdict(), "threads": plan.threads, "smem_bytes": plan.smem,
                    "blocks_per_sm": blocks, "threads_per_sm": blocks * plan.threads}
    return out


def _ptxas_lines(log) -> list:
    """ptxas's registers and spill lines of each kernel in an nvcc log."""
    return [ln.strip() for ln in str(log).splitlines() if "registers" in ln or "spill" in ln]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from protgram_directgcn_torch.ops import ell_kernels as ek
    from protgram_directgcn_torch.ops import epilogue_kernels as epk
    from protgram_directgcn_torch.ops import gat_kernels as gk
    from protgram_directgcn_torch.ops import hyper_kernels as hk
    from protgram_directgcn_torch.ops import hypercube as hyper
    from protgram_directgcn_torch.ops import optim_kernels as ok
    from protgram_directgcn_torch.ops import retile as rt
    from protgram_directgcn_torch.pipeline.trainer import HierarchicalTrainer
    from protgram_directgcn_torch.utils.device import resolve_device

    resolve_device(DEVICE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t_build = time.monotonic()
    with ThreadPoolExecutor(6) as pool:  # one nvcc per source, started together
        infos = dict(zip(("hyper", "ell", "retile", "optim", "gat", "epilogue"),
                         pool.map(lambda build: build(), (hk.build, ek.build, rt.build,
                                                          ok.build, gk.build, epk.build))))
    build_wall = time.monotonic() - t_build
    ptxas = {name: _ptxas_lines(info["log"]) for name, info in infos.items()}
    emit("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         build_wall_seconds=build_wall,
         build_seconds={name: info["seconds"] for name, info in infos.items()},
         built={name: info["built"] for name, info in infos.items()}, ptxas=ptxas,
         ell_occupancy=_ell_occupancy(ek))

    if sys.argv[1:] == ["--plant-faults"]:
        from protgram_directgcn_torch.graph.builder import NgramGraphBuilder

        with tempfile.TemporaryDirectory(prefix="protgram_faults_") as workdir:
            fasta = os.path.join(workdir, "synthetic_sprot.fasta")
            write_fasta(fasta, N_SEQS, seed=2024, lo=50, hi=1000)
            graph_paths = NgramGraphBuilder(n_max=4).run(fasta, os.path.join(workdir, "graphs"))
            return 0 if plant_faults(torch, graph_paths, workdir, fasta) else 1
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    doctor = start_doctor()
    records = check_kernels(torch, hk, hyper)
    k2_gc = check_k2_gc(torch, hk)
    with tempfile.TemporaryDirectory(prefix="protgram_smoke_") as workdir:
        fasta = os.path.join(workdir, "synthetic_sprot.fasta")
        residues = write_fasta(fasta, N_SEQS, seed=2024, lo=50, hi=1000)
        write_pairs(os.path.join(workdir, "positive.csv"), N_POSITIVE_PAIRS, N_SEQS, seed=1)
        write_pairs(os.path.join(workdir, "negative.csv"), N_NEGATIVE_PAIRS, N_SEQS, seed=2)
        emit("main_path_input", sequences=N_SEQS, residues=residues,
             positive_pairs=N_POSITIVE_PAIRS, negative_pairs=N_NEGATIVE_PAIRS)
        counts, main_graphs, pca_path = run_main_path(torch, hk, fasta, workdir)
        check_doctor(doctor)
        run_word2vec(torch, fasta, workdir)
        run_transformer(torch, fasta, workdir)
        run_ppi(torch, workdir)
        check_ppi_reference(torch, workdir, pca_path)
        torch.cuda.empty_cache()
        check_reference(torch, ek, workdir, "hypercube")
        check_tier_reference(torch, rt, workdir)
        torch.cuda.empty_cache()
        ell_counts, graph_paths = run_ell_path(torch, ek, fasta, workdir)
        torch.cuda.empty_cache()
        ell_records = check_ell_kernels(torch, ek, graph_paths)
        ell_edges = check_ell_edges(torch, ek, graph_paths)
        check_ell_routing(torch, ek, graph_paths)
        check_reference(torch, ek, workdir, "ell")
        torch.cuda.empty_cache()
        cluster_counts, cluster_graphs, level4 = run_cluster_path(torch, ek, fasta, workdir)
        torch.cuda.empty_cache()
        check_louvain(cluster_graphs, level4["louvain_seconds"])
        check_cluster_reference(torch, ek, cluster_graphs[3], level4["num_classes"])
        retile_records = check_retile_kernels(torch, rt)
        check_optim_kernels(torch, ok)
        check_epilogue_kernels(torch, epk)
        check_gat_kernels(torch, gk, graph_paths[3])
        with _OperatorCache(HierarchicalTrainer):
            tier_counts, tier_config, tier_graphs, tier3_peak = run_tier_path(
                torch, hk, rt, fasta, workdir)
            torch.cuda.empty_cache()
            run_free_memory_level(torch, tier_config, tier_graphs[TIER_N - 1], tier3_peak)
            torch.cuda.empty_cache()
            run_tier4_level(torch, hk, rt, tier_config, tier_graphs[TIER_N - 1], tier3_peak)
        torch.cuda.empty_cache()
        run_degrade_level(torch, tier_config, tier_graphs[3])
        check_native_etl(fasta)
        check_checkpoint(torch, hk, main_graphs[2], workdir)
        torch.cuda.empty_cache()
        bench_counts, bench_by_v = run_benchmark(torch, ek, workdir)
        bench_ell = check_bench_ell(torch, ek)
        check_bench_reference(torch, ek)
        torch.cuda.empty_cache()
        sddmm_counts = check_sddmm(torch, ek, hk, graph_paths)
        dist_counts = run_distributed(torch, graph_paths, workdir, fasta)
        torch.cuda.empty_cache()
        # The ell path's n = 4 level: the 5-gram level's five curves took 74 s
        # (PERF.md §4), over the 60 s this phase may take.
        run_scaling(torch, graph_paths[3])

    kernels = _kernels_line(records, counts, ell_records, ell_edges, ell_counts, retile_records,
                            tier_counts, cluster_counts, bench_counts, bench_by_v, bench_ell)
    for entry in kernels:  # the two newest paths' launches
        name = {"hyper_k1": "k1", "hyper_k2": "k2"}.get(entry["name"], entry["name"])
        if name == "k2":
            entry["x_gc"] = k2_gc
        for phase, per_kernel in dist_counts.items():
            if name in per_kernel:
                entry[f"launches_{phase}_path"] = per_kernel[name]
        if name in sddmm_counts:
            entry["launches_sddmm_path"] = sddmm_counts[name]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
