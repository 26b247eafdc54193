#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line as it ends:

0. device: the card's name and power limit (as nvidia-smi prints them), and
   the nvcc build of the K1/K2 kernels (csrc/hyper.cu) with its time;
1. kernels: K1 and K2, forward and the bank-swapped backward, held against
   their plain PyTorch versions at the main path's shapes (A=21, G=441 and
   21, F=256/128/64, float32 and bfloat16) and at the 5-gram hypercube
   (A=21, G=194,481, F=128, bfloat16); each timed on the device (launches
   captured in a CUDA graph, replays timed with CUDA events) beside its plain
   version and the one-call ``torch.einsum`` of the same contraction, and
   through its Python wrapper in a host loop (``wrapper_ms``);
2. main path: ``python -m protgram_directgcn_torch --stages graph,gcn``'s
   entry point on a seeded synthetic FASTA of Swiss-Prot-like size (20,000
   sequences, lengths 50-1,000), dims [256, 128, 64], n = 1..3, five epochs a
   level, with the kernels' launch counts set to 0 before and read after;
3. reference: the model's forward and gradients on the card against the
   port's CPU path (which the CPU tests hold against the JAX package) on a
   small n = 3 hypercube graph.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
then exits non-zero without that last line.  It exits non-zero at once when
no CUDA device is present.
"""

from __future__ import annotations

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
MAIN_SHAPES = [(21, g, f) for g in (441, 21) for f in (256, 128, 64)]
LARGE_SHAPE = (21, 194_481, 128)
SOURCE = "protgram_directgcn_torch/csrc/hyper.cu"
REPLACES = {
    "hyper_k1": "protgram_directgcn_tpu/ops/pallas_hyper.py:217",
    "hyper_k2": "protgram_directgcn_tpu/ops/pallas_hyper.py:245",
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "elapsed_s": round(time.monotonic() - T0, 3), **fields}),
          flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


# -----------------------------------------------------------------------------
# Phase 1: kernels
# -----------------------------------------------------------------------------


def _device_ms(torch, fn, iters: int, replays: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph,
    replayed ``replays`` times after a warm-up replay, timed with CUDA
    events.  The host's cost of issuing each call is outside the graph."""
    side = torch.cuda.Stream()
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


def check_kernels(torch, hk, hyper):
    """Hold K1/K2 (forward and swapped-bank backward) against the plain
    versions; time them.  Returns per-shape records."""
    records = []
    shapes = [(s, dt) for s in MAIN_SHAPES for dt in ("float32", "bfloat16")]
    shapes.append((LARGE_SHAPE, "bfloat16"))
    for (a, g, f), dt in shapes:
        tdt = getattr(torch, dt)
        gen = torch.Generator(device=DEVICE).manual_seed(a * 1_000_003 + g * 1009 + f)
        x = torch.randn(a, g, f, device=DEVICE, generator=gen).to(tdt)
        wf = torch.randn(a, g, a, device=DEVICE, generator=gen).to(tdt)
        wb = torch.randn(a, g, a, device=DEVICE, generator=gen).to(tdt)
        d = torch.randn(a, g, device=DEVICE, generator=gen)
        cot = torch.randn(a, g, f, device=DEVICE, generator=gen).to(tdt)
        scale, shift = 0.75, 0.125

        z = hk.k1(wf, x)
        out = hk.k2(d, wb, z.view(a, g, f), x, scale, shift)
        adj = hyper.HypercubeAdj(d=d, wf_rs=wf, wb_rs=wb,
                                 node_map=torch.arange(a * g, device=DEVICE))
        xg = x.clone().requires_grad_(True)
        y = hyper.propagate_hyper_affine(adj, xg, scale, shift)
        y.backward(cot)
        torch.cuda.synchronize()

        z_ref = hk.k1_plain(wf, x)
        out_ref = hk.k2_plain(d, wb, z.view(a, g, f), x, scale, shift)
        y_ref = hk.k2_plain(d, wb, z_ref.view(a, g, f), x, scale, shift)
        dx_ref = hk.k2_plain(d, wf, hk.k1_plain(wb, cot).view(a, g, f), cot, scale, 0.0)
        rec = {"shape": [a, g, f], "dtype": dt}
        for name, got, ref in (("k1", z, z_ref), ("k2", out, out_ref),
                               ("fwd", y.detach(), y_ref), ("bwd", xg.grad, dx_ref)):
            err, ok = _err(torch, got, ref, dt)
            rec[f"{name}_max_abs_err"] = err
            if not ok:
                fail(f"{name} disagrees with its plain version at A={a} G={g} F={f} {dt}: "
                     f"max abs err {err}")
            if not bool(torch.isfinite(got.float()).all()):
                fail(f"{name} produced non-finite values at A={a} G={g} F={f} {dt}")

        iters = 20 if g * f > 10_000_000 else 200
        zv = z.view(a, g, f)
        x_gc = x.view(g, a, f)
        fns = {
            "k1": lambda: hk.k1(wf, x),
            "k2": lambda: hk.k2(d, wb, zv, x, scale, shift),
            "k1_plain": lambda: hk.k1_plain(wf, x),
            "k2_plain": lambda: hk.k2_plain(d, wb, zv, x, scale, shift),
            "k1_library": lambda: torch.einsum("rgc,rgf->gcf", wf, x),
            "k2_library": lambda: torch.einsum("rgc,gcf->rgf", wb, x_gc),
        }
        for key, fn in fns.items():
            rec[f"{key}_ms"] = _device_ms(torch, fn, iters)
        for k in ("k1", "k2"):
            rec[f"{k}_wrapper_ms"] = _wrapper_ms(torch, fns[k], iters)
        for k in ("hyper_k1", "hyper_k2"):
            rec[f"{k[-2:]}_bound_ms"], rec[f"{k[-2:]}_bound_by"] = _bound(k, a, g, f, dt)
        emit("kernels", **rec)
        records.append(rec)
        del x, wf, wb, d, cot, z, out, xg, y, z_ref, out_ref, y_ref, dx_ref, adj, fns
        torch.cuda.empty_cache()
    return records


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


def run_main_path(torch, hk, workdir: str):
    from protgram_directgcn_torch.__main__ import main

    fasta = os.path.join(workdir, "synthetic_sprot.fasta")
    residues = write_fasta(fasta, N_SEQS, seed=2024, lo=50, hi=1000)
    emit("main_path_input", sequences=N_SEQS, residues=residues)
    argv = ["--fasta", fasta, "--out", os.path.join(workdir, "out"), "--stages", "graph,gcn",
            "--set", "gcn.hidden_layer_dims=[256,128,64]",
            "--set", "graph_builder.ngram_max_n=3",
            "--set", "gcn.epochs_per_level=5",
            "--set", "gcn.run_sanity_check_ppi=false",
            "--device", DEVICE]
    hk.reset_launches()
    t0 = time.monotonic()
    result = main(argv)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    counts = hk.launch_counts()

    trainer = result["trainer"]
    stats = trainer.level_stats
    for n in (1, 2, 3):
        if n not in stats:
            fail(f"level n={n} did not train")
        st = stats[n]
        if not all(map(lambda v: v == v and abs(v) != float("inf"), st["losses"])):
            fail(f"level n={n} has non-finite losses {st['losses']}")
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
    pooled = result["pooled"]
    import numpy as np

    vecs = np.stack(list(pooled.values()))
    if len(pooled) != N_SEQS or vecs.shape != (N_SEQS, 64) or not np.isfinite(vecs).all():
        fail(f"pooled embeddings: {len(pooled)} proteins, shape {vecs.shape}, "
             f"finite={bool(np.isfinite(vecs).all())}")
    emit("main_path", seconds=seconds, launches=counts, proteins=len(pooled),
         pooled_dim=int(vecs.shape[1]))
    return counts


# -----------------------------------------------------------------------------
# Phase 3: reference on a small input
# -----------------------------------------------------------------------------


def check_reference(torch, workdir: str):
    """Forward and gradients of the model on the card against the port's
    CPU path, on a small n = 3 hypercube graph (rtol 1e-4, atol 1e-5 *
    max|leaf|: float32 with TF32 off, summed in another order)."""
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
    for dev in (DEVICE, "cpu"):
        dg = graph.to_device(mode="hypercube", device=dev)
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
    worst = 0.0
    for got, ref in zip(outs[DEVICE], outs["cpu"]):
        if not bool(torch.isfinite(got).all()):
            fail("non-finite model output or gradient on the card")
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        err = (got - ref).abs()
        if not bool((err <= tol + 1e-4 * ref.abs()).all()):
            fail(f"card and CPU disagree: max abs err {float(err.max())}")
        worst = max(worst, float(err.max()))
    emit("reference", nodes=graph.num_nodes, hypercube_nodes=int(outs["cpu"][0].shape[0]),
         tensors_compared=len(outs["cpu"]), max_abs_err=worst)


# -----------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    from protgram_directgcn_torch.ops import hyper_kernels as hk
    from protgram_directgcn_torch.ops import hypercube as hyper
    from protgram_directgcn_torch.utils.device import resolve_device

    resolve_device(DEVICE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    info = hk.build()
    ptxas = [ln.strip() for ln in str(info["log"]).splitlines() if "registers" in ln]
    emit("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         build_seconds=info["seconds"], built=info["built"], ptxas=ptxas)

    records = check_kernels(torch, hk, hyper)
    with tempfile.TemporaryDirectory(prefix="protgram_smoke_") as workdir:
        counts = run_main_path(torch, hk, workdir)
        check_reference(torch, workdir)

    # One entry per kernel: its numbers at the main path's widest shape, then
    # the 5-gram shape's and the worst error of each type over every shape.
    main_rec = next(r for r in records if r["shape"] == [21, 441, 256] and r["dtype"] == "float32")
    large_rec = next(r for r in records
                     if r["shape"] == list(LARGE_SHAPE) and r["dtype"] == "bfloat16")
    kernels = []
    for name in ("hyper_k1", "hyper_k2"):
        k = name[-2:]
        worst = {}
        for r in records:
            cur = worst.get(r["dtype"])
            if cur is None or r[f"{k}_max_abs_err"] > cur["max_abs_err"]:
                worst[r["dtype"]] = {"max_abs_err": r[f"{k}_max_abs_err"], "shape": r["shape"]}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
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
            | {"shape": large_rec["shape"], "dtype": large_rec["dtype"]},
            "worst_max_abs_err_by_dtype": worst,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
