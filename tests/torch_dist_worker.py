"""Rank processes for the port's node-sharded tests (imports torch and the
port only: the JAX references run in the parent test process).

``spawn`` starts ``world_size`` ranks with the spawn start method, each
joining a gloo group through a ``FileStore`` in the test's directory (no
fixed port), with one intra-op thread, and waits at most ``timeout``
seconds.  The scenario functions write each rank's results to
``{tmpdir}/{name}_r{rank}.npz`` or ``.pkl``.
"""

import os
import pickle
import time

import numpy as np


def spawn(fn, world_size: int, tmpdir: str, *args, timeout: float = 240.0) -> None:
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world_size, str(tmpdir), *args), nprocs=world_size,
                             start_method="spawn", join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks of {fn.__name__} still running after {timeout} s")


def _init(rank: int, world_size: int, tmpdir: str) -> None:
    import torch

    from protgram_directgcn_torch.parallel import distributed as comm

    torch.set_num_threads(1)
    comm.initialize_distributed(init_method="file://" + os.path.join(tmpdir, "store"),
                                world_size=world_size, rank=rank, device="cpu")


# ----------------------------------------------------------------------------
# Seeded inputs, built the same way by the parent and the ranks
# ----------------------------------------------------------------------------


def random_coo(n=50, edges=220, seed=0):
    rng = np.random.default_rng(seed)
    pairs = np.unique(np.stack([rng.integers(0, n, edges), rng.integers(0, n, edges)], 1), axis=0)
    w = rng.uniform(0.2, 1.0, len(pairs)).astype(np.float32)
    return pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64), w


def ngram_coo(alphabet=5, n=3, deg=3, seed=0):
    """Suffix-overlapping n-gram transitions with self loops over the whole
    hypercube (tests/test_hyper_shard.py:26-43)."""
    rng = np.random.default_rng(seed)
    num = alphabet**n
    codes = np.stack(np.meshgrid(*[np.arange(alphabet)] * n, indexing="ij"), -1).reshape(num, n)
    src = np.repeat(np.arange(num, dtype=np.int64), deg)
    sfx = np.repeat(codes[:, 1:] @ (alphabet ** np.arange(n - 2, -1, -1)), deg)
    tgt = sfx * alphabet + rng.integers(0, alphabet, num * deg)
    src = np.concatenate([src, np.arange(num, dtype=np.int64)])
    tgt = np.concatenate([tgt, np.arange(num, dtype=np.int64)])
    pairs, counts = np.unique(np.stack([src, tgt], 1), axis=0, return_counts=True)
    return pairs[:, 0], pairs[:, 1], counts.astype(np.float32) * 0.25, codes, alphabet, num


def features(n, f, seed):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


HALO_N, HALO_F = 50, 6
HYPER_F = 8
SCALE, SHIFT = 0.5, 0.25


# ----------------------------------------------------------------------------
# Propagation scenarios
# ----------------------------------------------------------------------------


def parallel_scenarios(rank: int, world_size: int, tmpdir: str) -> None:
    """Every rank's rows of: the halo and tri-halo products and VJPs (with
    checksums), the key-sharded hypercube's (f32 with scale/shift, bf16)
    and its tri operator's (both orientations' exchange batched), each
    forward output ``out_*`` and input gradient ``dx_*`` for the cotangent
    ``features(..., seed=9)``; and whether a corrupted exchange trips the
    checksums."""
    import torch

    _init(rank, world_size, tmpdir)
    from protgram_directgcn_torch.parallel import distributed as comm
    from protgram_directgcn_torch.parallel import halo, hyper_shard as hs

    res = {}
    coos = [random_coo(HALO_N, seed=s) for s in (0, 1, 2)]
    x = features(HALO_N, HALO_F, 3)
    cot = features(HALO_N, HALO_F, 9)
    adj = halo.build_halo_adjacency(*coos[0], HALO_N, world_size, rank, "cpu",
                                    debug_checksums=True)
    rows = adj.node_rows().numpy()
    pad = lambda a: halo.pad_node_features(a, adj.fwd)[rows]  # noqa: E731
    xl = torch.from_numpy(pad(x)).requires_grad_(True)
    out = halo.propagate(adj, xl)
    (out * torch.from_numpy(pad(cot))).sum().backward()
    res.update(halo_rows=rows, out_halo=out.detach().numpy(), dx_halo=xl.grad.numpy())

    tri = halo.build_tri_halo_adjacency(coos, HALO_N, world_size, rank, "cpu")
    xs = [torch.from_numpy(pad(features(HALO_N, HALO_F, 3 + m))).requires_grad_(True)
          for m in range(3)]
    outs = halo.propagate_tri(tri, *xs)
    sum((o * torch.from_numpy(pad(cot))).sum() for o in outs).backward()
    for m in range(3):
        res[f"out_trihalo{m}"] = outs[m].detach().numpy()
        res[f"dx_trihalo{m}"] = xs[m].grad.numpy()

    src, tgt, w, codes, a, num = ngram_coo()
    mats = [ngram_coo(seed=s)[:3] for s in (0, 1, 2)]
    tables = hs.build_hyper_shard_tables(a, a ** 2, world_size)
    hadj = [hs.build_hyper_shard(*m, codes, a, world_size, rank, "cpu", tables=tables)
            for m in mats]
    hrows = hadj[0].node_rows().numpy()
    res["hyper_rows"] = hrows

    def hpad(arr):
        full = np.zeros((hadj[0].global_nodes, arr.shape[1]), np.float32)
        full[hadj[0].node_map] = arr
        return torch.from_numpy(full[hrows])

    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        one = hs.build_hyper_shard(*mats[0], codes, a, world_size, rank, "cpu",
                                   weights_dtype=dt, tables=tables)
        xl = hpad(features(num, HYPER_F, 4)).to(dt).requires_grad_(True)
        out = hs.propagate(one, xl, SCALE, SHIFT)
        (out.float() * hpad(features(num, HYPER_F, 9))).sum().backward()
        res[f"out_hyper_{tag}"] = out.detach().float().numpy()
        res[f"dx_hyper_{tag}"] = xl.grad.float().numpy()
    trio = hs.HyperShardTri(adjs=tuple(hadj))
    xs = [hpad(features(num, HYPER_F, 4 + m)).requires_grad_(True) for m in range(3)]
    outs = hs.propagate_tri(trio, *xs)
    sum((o * hpad(features(num, HYPER_F, 9))).sum() for o in outs).backward()
    for m in range(3):
        res[f"out_hypertri{m}"] = outs[m].detach().numpy()
        res[f"dx_hypertri{m}"] = xs[m].grad.numpy()

    # A corrupted feature exchange: every rank's received rows are off by
    # one, and every rank's checksum check must trip.
    real = comm.all_to_all
    calls = {"n": 0}

    def corrupt(send, out_splits=None, in_splits=None, group=None):
        calls["n"] += 1
        got = real(send, out_splits, in_splits, group)
        return got + 1.0 if calls["n"] == 1 else got

    comm.all_to_all = corrupt
    try:
        halo.propagate(adj, torch.from_numpy(pad(x)))
        res["checksum_tripped"] = np.array(False)
    except RuntimeError as exc:
        res["checksum_tripped"] = np.array("checksum mismatch" in str(exc))
    finally:
        comm.all_to_all = real
    res["exchange_calls"] = np.array(comm.EXCHANGE["calls"])
    np.savez(os.path.join(tmpdir, f"parallel_r{rank}.npz"), **res)


def gspmd_scenarios(rank: int, world_size: int, tmpdir: str) -> None:
    """Every rank's rows of the gspmd mode's row-sharded ELL product and
    VJP (``out_gspmd``, ``dx_gspmd``) and of its tri operator's
    (``out_gspmdtri{m}``, ``dx_gspmdtri{m}``), for the cotangent
    ``features(..., seed=9)``, and the all-gathers counted."""
    import torch

    _init(rank, world_size, tmpdir)
    from protgram_directgcn_torch.parallel import distributed as comm
    from protgram_directgcn_torch.parallel import gspmd

    res = {}
    coos = [random_coo(HALO_N, seed=s) for s in (0, 1, 2)]
    ops = [gspmd.RowShardEllAdj.from_tables(
        gspmd.build_row_shard_tables(*c, HALO_N, world_size), world_size, rank, "cpu")
        for c in coos]
    rows = ops[0].node_rows().numpy()
    total = ops[0].global_nodes

    def pad(a):
        return torch.from_numpy(np.pad(a, ((0, total - len(a)), (0, 0)))[rows])

    cot = pad(features(HALO_N, HALO_F, 9))
    xl = pad(features(HALO_N, HALO_F, 3)).requires_grad_(True)
    out = gspmd.propagate(ops[0], xl)
    (out * cot).sum().backward()
    res.update(rows=rows, out_gspmd=out.detach().numpy(), dx_gspmd=xl.grad.numpy())
    xs = [pad(features(HALO_N, HALO_F, 3 + m)).requires_grad_(True) for m in range(3)]
    outs = gspmd.propagate_tri(gspmd.RowShardTri(adjs=tuple(ops)), *xs)
    sum((o * cot).sum() for o in outs).backward()
    for m in range(3):
        res[f"out_gspmdtri{m}"] = outs[m].detach().numpy()
        res[f"dx_gspmdtri{m}"] = xs[m].grad.numpy()
    res["exchange_calls"] = np.array(comm.EXCHANGE["calls"])
    np.savez(os.path.join(tmpdir, f"gspmd_r{rank}.npz"), **res)


def scaling_scenarios(rank: int, world_size: int, tmpdir: str, graph_path: str) -> None:
    """The scaling harness's three reports at D = 1 and 2 on a small size,
    every curve of the fixed-graph one on the level saved at ``graph_path``;
    rank 0 writes the points."""
    _init(rank, world_size, tmpdir)
    from protgram_directgcn_torch.bench import scaling

    counts = [1, 2]
    out = {"weak": [p.__dict__ for p in scaling.weak_scaling_report(
               nodes_per_shard=64, deg=4, feat_dim=4, shard_counts=counts, iters=2,
               device="cpu")],
           "uniform": [p.__dict__ for p in scaling.weak_scaling_report(
               nodes_per_shard=64, deg=4, feat_dim=4, shard_counts=counts, iters=2,
               graph="uniform", device="cpu")],
           "hyper": [p.__dict__ for p in scaling.hyper_shard_scaling_report(
               keys_per_shard=8, alpha=4, feat_dim=4, shard_counts=counts, iters=2,
               device="cpu")],
           "fivegram": scaling.fivegram_scaling_report(
               feat_dim=4, shard_counts=counts, iters=2, graph_path=graph_path, device="cpu")}
    if rank == 0:
        with open(os.path.join(tmpdir, "scaling_r0.pkl"), "wb") as fh:
            pickle.dump(out, fh)


# ----------------------------------------------------------------------------
# Trainer scenarios
# ----------------------------------------------------------------------------


def trainer_scenarios(rank: int, world_size: int, tmpdir: str) -> None:
    """``HierarchicalTrainer.train_level`` on the node shards for each run in
    ``{tmpdir}/runs.pkl`` (graph file, inputs, config overrides, the initial
    parameters to inject, optional checkpoint directory), dropout 0 in the
    decoder too; rank 0 writes each run's losses, embeddings, stats and the
    final parameters gathered to the whole level (node rows and feature
    columns)."""
    import torch

    _init(rank, world_size, tmpdir)
    from protgram_directgcn_torch import convert
    from protgram_directgcn_torch.config import Config
    from protgram_directgcn_torch.graph.structure import load_graph
    from protgram_directgcn_torch.models import directgcn as t_model
    from protgram_directgcn_torch.models.directgcn import named_leaves
    from protgram_directgcn_torch.pipeline import trainer as t_trainer

    with open(os.path.join(tmpdir, "runs.pkl"), "rb") as fh:
        runs = pickle.load(fh)
    t_trainer.DirectGCNConfig = lambda **kw: t_model.DirectGCNConfig(**kw, decoder_dropout=0.0)
    out = {}
    for name, run in runs.items():
        if run.get("world_size", world_size) != world_size:
            continue
        init = run.get("params")
        if init is not None:
            t_trainer.init_directgcn_params = (
                lambda gen, cfg, device, _p=init: convert.params_from_jax(_p, device="cpu"))
        cfg = Config()
        for k, v in run["set"].items():
            cfg.apply_overrides({k: v})
        tr = t_trainer.HierarchicalTrainer(cfg, device="cpu")
        g = load_graph(run["graph"])
        for epochs in run.get("cut", [None]):
            if epochs is not None:
                tr.gcn.epochs_per_level = epochs
            params, emb, _, dg = tr.train_level(g, run["x"], run["y"], run["classes"],
                                                ckpt_dir=run.get("ckpt_dir"))
        st = tr.level_stats[g.n]
        shard = t_trainer.NodeShard(dg.p_in, int(dg.p_in.global_nodes), tr._rank_layout())
        with torch.no_grad():
            whole = {}
            for i, (k, p) in enumerate(named_leaves(params)):
                whole[f"{i}:{k}"] = shard.full(k, p, p).detach().numpy()
        out[name] = {"losses": st["losses"], "route": st["route"], "embeds": emb,
                     "params": whole, "start_epoch": st.get("start_epoch"),
                     "world_size": st.get("world_size"), "rank_nodes": st.get("rank_nodes")}
    if rank == 0:
        with open(os.path.join(tmpdir, "trainer_r0.pkl"), "wb") as fh:
            pickle.dump(out, fh)
