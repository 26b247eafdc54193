"""The ELL kernels' launch plan (``ops/ell_kernels.py`` ``launch_plan``).

The kernels run only on the card; the geometry they launch with is computed
here in Python before each launch, from the shapes alone, so these tests
hold it on the CPU: every output row and feature of a launch is served by
exactly one thread, 16-byte accesses are taken exactly where they are
possible, the block and its shared memory fit what the entry points accept
(csrc/ell.cu ``launch``), each table size takes its regime (tile, threads,
streaming hints), including the n-gram operators' shapes, and the wrappers
pass the plan and count each launch by the features a thread owns.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from protgram_directgcn_torch.graph import transforms
from protgram_directgcn_torch.graph.builder import NgramGraphBuilder
from protgram_directgcn_torch.ops import _nvcc
from protgram_directgcn_torch.ops import ell_kernels as ek
from protgram_directgcn_torch.ops import spmm
from protgram_directgcn_torch.utils.io import parse_fasta
from tests.test_torch_graph import write_seeded_fasta

ROWS = (1, 21, 441, 1003, 8_401, 167_325)
N_INS = (1, 5_000, 167_325)  # x of at most 16 MB or more at every F below
KS = (0, 1, 4, 44, 150, 300)
WIDTHS = (1, 3, 4, 37, 64, 100, 128, 256, 512)


def _covered_once(n: int, blocks: int, per_block: int) -> bool:
    """Blocks of ``per_block`` consecutive items, the ones past ``n`` idle:
    is every item in [0, n) taken exactly once, and does every block take
    at least one?"""
    items = (np.arange(blocks)[:, None] * per_block + np.arange(per_block)[None, :]).ravel()
    counts = np.bincount(items[items < n], minlength=n)
    return bool((counts == 1).all()) and (blocks - 1) * per_block < max(n, 1)


def _entry_point_takes(plan: ek.LaunchPlan, n_out: int, k: int, f: int) -> bool:
    """The checks of csrc/ell.cu ``launch`` (n_out, f > 0)."""
    ct, rows, threads = plan.ct, plan.rows, plan.threads
    nvec = f // plan.v
    return (plan.v in (1, 4) and f % plan.v == 0 and ct & (ct - 1) == 0 and rows >= 1
            and threads <= ek.MAX_THREADS and threads % 32 == 0 and plan.kc >= 1
            and rows * plan.kc * 8 == plan.smem <= ek.MAX_SMEM
            and plan.grid[0] * rows >= n_out and plan.grid[1] * ct >= nvec
            and (plan.grid[0] - 1) * rows < n_out and (plan.grid[1] - 1) * ct < nvec
            and plan.grid[1] <= 65_535)


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "misaligned"])
def test_launch_plan(aligned, f):
    for n_out, k, n_in in itertools.product(ROWS, KS, N_INS):
        small = n_in * f * 4 <= ek.SMALL_TABLE_BYTES
        tile_bytes = ek.SMALL_TABLE_TILE_BYTES if small else ek.TILE_BYTES
        threads = ek.SMALL_TABLE_THREADS if small else ek.THREADS
        plan = ek.launch_plan(n_out, k, f, aligned, n_in)
        where = f"N_out={n_out} K={k} F={f} N_in={n_in} aligned={aligned}: {plan}"
        assert plan.v == (4 if aligned and f % 4 == 0 else 1), where
        assert _entry_point_takes(plan, n_out, k, f), where
        # Thread t of block (bx, by): row bx * rows + t // ct, chunk by * ct + t % ct.
        assert _covered_once(n_out, plan.grid[0], plan.rows), where
        assert _covered_once(f // plan.v, plan.grid[1], plan.ct), where
        # A row's tile is at most tile_bytes, and no wider than F needs.
        assert plan.ct * plan.v * 4 <= max(tile_bytes, 4 * plan.v), where
        assert plan.ct < 2 * max(1, f // plan.v), where
        assert plan.kc <= max(k, 1), where
        assert plan.smem <= ek.STAGE_BYTES, where
        assert plan.threads == threads, where
        assert plan.stream_hints == (not small), where


def test_default_plan_at_the_paths_shapes():
    """The n = 4 level's shape: 16 rows of a 32-feature (128-byte) tile, all
    44 slots in one pass, the feature tiles on the grid's y; the n = 3
    level's table (8.6 MB at F = 256) takes 64-feature tiles, 256 threads a
    block and no streaming hints."""
    plan = ek.launch_plan(167_325, 44, 256, True, 167_325)
    assert plan == ek.LaunchPlan(v=4, ct=8, rows=16, kc=44, grid=(10_458, 8), stream_hints=True)
    assert plan.threads == 128 and plan.smem == 5_632
    assert ek.launch_plan(8_401, 44, 256, True, 8_401) == ek.LaunchPlan(
        v=4, ct=16, rows=16, kc=44, grid=(526, 4))
    assert ek.launch_plan(8_401, 44, 64, True, 8_401).grid == (526, 1)
    assert ek.launch_plan(167_325, 44, 37, True, 167_325).v == 1


def test_bounds_are_read_from_the_source():
    src = (_nvcc.CSRC / "ell.cu").read_text()
    assert f"constexpr int kMaxThreads = {ek.MAX_THREADS};" in src
    assert f"constexpr int kMaxSmemBytes = {ek.MAX_SMEM};" in src
    assert ek.MAX_SMEM == 48 * 1024  # without the opt-in attribute


@pytest.fixture(scope="module")
def ngram3(tmp_path_factory):
    fasta = write_seeded_fasta(tmp_path_factory.mktemp("plan") / "seq.fasta", n_seqs=40,
                               lo=30, hi=120)
    return NgramGraphBuilder(n_max=3).build_from_sequences(list(parse_fasta(fasta)))[2]


@pytest.mark.parametrize("matrix", ["mathcal_a_in", "mathcal_a_out", "undirected_norm"])
def test_plan_on_ngram_operators(ngram3, matrix):
    """Both orientations of the n = 3 operators at the paths' widths: the
    small-table regime, all K slots in one pass, every row and feature
    covered once; a large table of the same operator takes the other."""
    src, tgt, val = transforms.csr_to_coo_arrays(getattr(ngram3, matrix)())
    adj = spmm.build_ell(src, tgt, val, ngram3.num_nodes, device="cpu")
    for idx in (adj.idx, adj.idx_t):
        n, k = idx.shape
        for f in (64, 128, 256):
            plan = ek.launch_plan(n, k, f, True, n)
            assert (plan.v, plan.threads, plan.ct * 16, plan.kc) == (4, 256, 256, k)
            assert not plan.stream_hints and _entry_point_takes(plan, n, k, f)
            assert _covered_once(n, plan.grid[0], plan.rows)
            big = ek.launch_plan(n, k, f, True, 1 << 20)
            assert (big.threads, big.ct * 16, big.stream_hints) == (128, 128, True)


class _FakeLib:
    """Stands in for the nvcc-built library: records each call's shape and
    plan arguments, returns 0."""

    def __init__(self):
        self.calls, self.args = [], []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args[4:13]))
            self.args.append(args)
            return 0
        return fn


def test_wrapper_passes_the_plan_and_counts_by_v(monkeypatch):
    fake = _FakeLib()
    monkeypatch.setattr(ek, "_lib", fake)
    monkeypatch.setattr(_nvcc, "stream_ptr", lambda t: 0)
    ek.reset_launches()
    idx = torch.zeros(1003, 150, dtype=torch.int32)
    w = torch.zeros(1003, 150)
    base = torch.zeros(5000 * 256 + 4)
    assert base.data_ptr() % 16 == 0
    aligned, shifted = base[:-4].view(5000, 256), base[1:-3].view(5000, 256)
    ek._launch_cuda("ell_resident", idx, w, aligned, "fwd")
    ek._launch_cuda("ell_resident", idx, w, shifted, "bwd")
    ek._launch_cuda("ell_hbm", idx, w, torch.zeros(5000, 37), "fwd")
    large = torch.zeros(120_000, 37)  # 17.8 MB: past SMALL_TABLE_BYTES
    ek._launch_cuda("ell_hbm", idx, w, large, "fwd")
    plan = ek.launch_plan(1003, 150, 37, True, 120_000)
    assert plan.stream_hints and plan.threads == ek.THREADS
    want = [("ell_resident_f32", 256, ek.launch_plan(1003, 150, 256, True, 5000)),
            ("ell_resident_f32", 256, ek.launch_plan(1003, 150, 256, False, 5000)),
            ("ell_hbm_f32", 37, ek.launch_plan(1003, 150, 37, True, 5000)),
            ("ell_hbm_f32", 37, plan)]
    assert fake.calls == [(n, (1003, 150, f, p.v, p.ct, p.rows, p.kc, *p.grid))
                          for n, f, p in want]
    # ..., the plan, the streaming hints (a large table only), the stream
    assert [a[-2] for a in fake.args] == [0, 0, 0, 1]
    assert ek.launch_counts_by_v() == {"ell_resident": {4: 1, 1: 1}, "ell_hbm": {1: 2}}
    assert ek.launch_counts() == {"ell_resident": {"fwd": 1, "bwd": 1},
                                  "ell_hbm": {"fwd": 2, "bwd": 0}}
    ek.reset_launches()
    assert ek.launch_counts_by_v() == {"ell_resident": {}, "ell_hbm": {}}
