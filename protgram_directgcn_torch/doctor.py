"""Environment doctor for the PyTorch/CUDA port:
``python -m protgram_directgcn_torch.doctor [--cpu]``.

Port of tools/doctor.py:28-88, which checks the TPU stack, for the card's:
one ``[ok]`` / ``[!!]`` line a check, exit 1 if any check fails.

- libraries: torch, the CUDA it was built for, numpy, scipy;
- the card: its name and power limit (``nvidia-smi --query-gpu=name,
  power.limit --format=csv,noheader``);
- a bfloat16 512 x 512 ``torch.matmul`` on the card;
- ``nvcc`` and its version, and the builds of the three kernel sources
  (``csrc/*.cu`` through ``ops/_nvcc.py``; a cached build counts);
- ``g++``, and the C++ ETL and Louvain libraries loading;
- NCCL's availability, and a 2-rank gloo ``all_to_all_single`` in a
  subprocess of its own.

``--cpu`` skips the card's checks (the card, nvcc, the kernel builds, NCCL)
and runs the matmul on the CPU.  Without ``--cpu`` and without a card the
card's check fails, naming CUDA: nothing is skipped quietly.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def check(name: str, fn) -> bool:
    try:
        result = fn()
        print(f"  [ok] {name}: {result}", flush=True)
        return True
    except Exception as e:
        print(f"  [!!] {name}: {type(e).__name__}: {e}", flush=True)
        return False


def _versions() -> str:
    import numpy
    import scipy
    import torch

    return (f"torch {torch.__version__} (CUDA {torch.version.cuda}), numpy {numpy.__version__}, "
            f"scipy {scipy.__version__}, python {sys.version.split()[0]}")


def _card() -> str:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available (no card visible to torch); pass --cpu to "
                           "check the CPU stack alone")
    smi = shutil.which("nvidia-smi")
    limit = "nvidia-smi not found"
    if smi:
        limit = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=60).stdout.strip()
    return f"{torch.cuda.device_count()}x {torch.cuda.get_device_name(0)}; nvidia-smi: {limit}"


def _matmul(device: str):
    def run() -> str:
        import torch

        a = torch.ones((512, 512), dtype=torch.bfloat16, device=device)
        t0 = time.monotonic()
        out = torch.matmul(a, a)
        value = float(out[0, 0])  # waits for the device
        if value != 512.0:
            raise RuntimeError(f"512x512 bf16 matmul gave {value}, expected 512")
        return f"512x512 bf16 matmul on {device} ok ({time.monotonic() - t0:.3f}s)"
    return run


def _nvcc() -> str:
    from protgram_directgcn_torch.ops import _nvcc as nv

    proc = subprocess.run([nv.nvcc(), "--version"], capture_output=True, text=True, timeout=60)
    return proc.stdout.strip().splitlines()[-1]


def _kernels() -> str:
    from protgram_directgcn_torch.ops import ell_kernels, hyper_kernels, retile

    parts = []
    for mod in (hyper_kernels, ell_kernels, retile):
        info = mod.build()
        parts.append(f"{os.path.basename(str(info['path']))} "
                     f"({'built' if info['built'] else 'cached'} {info['seconds']:.1f}s)")
    return ", ".join(parts)


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found (the C++ ETL and Louvain sweep need it)")
    return subprocess.run([gxx, "--version"], capture_output=True, text=True,
                          timeout=60).stdout.splitlines()[0]


def _host_libs() -> str:
    from protgram_directgcn_torch import native
    from protgram_directgcn_torch.graph import community

    if not native.available():
        raise RuntimeError("the C++ ETL (csrc/ngram_etl.cpp) did not build or load")
    return f"ETL {native.BUILD_INFO.get('path', 'loaded')}, Louvain {community.build()['path']}"


def _nccl() -> str:
    import torch.distributed as dist

    if not dist.is_nccl_available():
        raise RuntimeError("this torch build has no NCCL")
    import torch

    return f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}"


def _gloo_rank(rank: int, world: int, store: str) -> None:
    """One rank of the gloo check: an ``all_to_all_single`` of ranked rows."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="file://" + store, world_size=world, rank=rank)
    try:
        send = torch.arange(world, dtype=torch.float32) + 10 * rank
        out = torch.empty(world)
        dist.all_to_all_single(out, send)
        want = torch.arange(world, dtype=torch.float32) * 10 + rank
        if not torch.equal(out, want):
            raise RuntimeError(f"rank {rank} received {out.tolist()}, expected {want.tolist()}")
    finally:
        dist.destroy_process_group()


def _gloo() -> str:
    with tempfile.TemporaryDirectory() as tmp:
        code = ("import sys, torch.multiprocessing as mp; "
                "from protgram_directgcn_torch.doctor import _gloo_rank; "
                "mp.spawn(_gloo_rank, args=(2, sys.argv[1]), nprocs=2)")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (_ROOT, os.environ.get("PYTHONPATH", "")) if p))
        proc = subprocess.run([sys.executable, "-c", code, os.path.join(tmp, "store")],
                              env=env, capture_output=True, text=True, timeout=180)
        if proc.returncode != 0:
            raise RuntimeError(proc.stderr.strip()[-400:])
    return "2 ranks, all_to_all_single ok"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Check the PyTorch/CUDA port's environment")
    p.add_argument("--cpu", action="store_true", help="skip the card's checks")
    args = p.parse_args(argv)
    print("== ProtGram-DirectGCN PyTorch/CUDA environment doctor ==", flush=True)
    checks = [("libraries", _versions)]
    if not args.cpu:
        checks += [("card", _card), ("card matmul", _matmul("cuda")), ("nvcc", _nvcc),
                   ("kernel builds", _kernels)]
    else:
        checks += [("cpu matmul", _matmul("cpu"))]
    checks += [("g++", _gxx), ("ETL and Louvain libraries", _host_libs)]
    if not args.cpu:
        checks += [("NCCL", _nccl)]
    checks += [("gloo all_to_all_single (subprocess)", _gloo)]
    ok = True
    for name, fn in checks:
        ok &= check(name, fn)
    print("== all checks passed ==" if ok else "== some checks FAILED ==", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
