"""The K1/K2 launch plan (``ops/hyper_kernels.py`` ``launch_plan``).

The kernels run only on the card; the geometry they launch with is computed
here in Python before each launch, so these tests hold it on the CPU: every
feature column of every key is covered by exactly one thread, 16-byte
accesses are taken exactly where they are possible, and the block, shared
memory and grid fit the card and fill its SMs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from protgram_directgcn_torch.ops import hyper_kernels as hk

ALPHABETS = range(1, 33)
WIDTHS = (1, 7, 8, 37, 64, 100, 128, 256, 512)
KEYS = (1, 21, 441, 194_481)
SMEM_LIMIT = 48 * 1024  # static and dynamic shared memory without the opt-in attribute
SMS = 132  # streaming multiprocessors of an H100 SXM


def _shared_bytes(keys: int, amax: int) -> int:
    """Shared memory of a block: per key an f32 slab [amax, OP] and a
    diagonal row [OP], OP being amax rounded up to 4 floats (16 bytes)."""
    return 4 * keys * (amax + 1) * (-(-amax // 4) * 4)


def _covered_once(n: int, blocks: int, per_block: int) -> bool:
    """Blocks of ``per_block`` consecutive items, the ones past ``n`` idle:
    is every item in [0, n) taken exactly once?"""
    items = (np.arange(blocks)[:, None] * per_block + np.arange(per_block)[None, :]).ravel()
    counts = np.bincount(items[items < n], minlength=n)
    return bool((counts == 1).all())


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("g", KEYS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_launch_plan(dtype, g, aligned):
    itemsize = dtype.itemsize
    for a in ALPHABETS:
        for f in WIDTHS:
            plan = hk.launch_plan(a, g, f, dtype, aligned, SMS)
            where = f"A={a} G={g} F={f} {dtype} aligned={aligned}: {plan}"
            vector = aligned and (f * itemsize) % 16 == 0
            assert plan.v == (16 // itemsize if vector else 1), where
            assert f % plan.v == 0, where
            # Thread t of block (bx, by) takes key bx * keys + t // ct and
            # chunk by * ct + t % ct, that is features [chunk * v, chunk * v + v).
            assert plan.threads >= plan.keys * plan.ct, where
            assert _covered_once(g, plan.grid[0], plan.keys), where
            assert _covered_once(f // plan.v, plan.grid[1], plan.ct), where
            assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024, where
            assert plan.threads <= hk.MAX_THREADS, where
            assert plan.grid[1] <= 65_535, where
            assert plan.keys <= hk.MAX_KEYS, where
            assert _shared_bytes(plan.keys, plan.amax) <= SMEM_LIMIT, where
            assert plan.grid[0] * plan.grid[1] >= min(g, SMS), where


@pytest.mark.parametrize("a", ALPHABETS)
def test_padded_alphabet_bounds_every_alphabet(a):
    # Two instantiations: A = 21 (every path's alphabet) and the bound 32.
    plan = hk.launch_plan(a, 194_481, 128, torch.bfloat16, True, SMS)
    assert plan.amax == (21 if a == 21 else hk.MAX_ALPHABET) and a <= plan.amax
    assert plan.keys == hk.MAX_KEYS
    assert _shared_bytes(plan.keys, plan.amax) <= SMEM_LIMIT


def test_plan_refuses_alphabets_past_the_bound():
    for a in (0, hk.MAX_ALPHABET + 1):
        with pytest.raises(ValueError):
            hk.launch_plan(a, 441, 128, torch.float32, True, SMS)


@pytest.mark.parametrize("sms", [66, 114, 132])
def test_grid_fills_the_sms_of_the_card(sms):
    for g in KEYS:
        plan = hk.launch_plan(21, g, 128, torch.bfloat16, True, sms)
        assert plan.grid[0] * plan.grid[1] >= min(g, sms)
        assert _covered_once(g, plan.grid[0], plan.keys)
    assert hk.launch_plan(21, 441, 128, torch.bfloat16, True, sms).keys == 441 // sms


def test_keys_a_block_follow_the_key_count():
    # 16 threads a key at F = 128 in bf16: the thread bound leaves the key
    # count to G.  At F = 256 in f32 (64 threads a key) it caps keys at 4.
    keys = {g: hk.launch_plan(21, g, 128, torch.bfloat16, True, SMS).keys for g in KEYS}
    assert keys == {1: 1, 21: 1, 441: 3, 194_481: hk.MAX_KEYS}
    assert hk.launch_plan(21, 194_481, 256, torch.float32, True, SMS).keys == 4


def test_alignment_is_read_from_the_pointers():
    base = torch.zeros(21 * 441 * 256 + 1)
    assert hk._aligned(base[:-1].view(21, 441, 256))
    view = base[1:].view(21, 441, 256)  # contiguous, one element past an aligned start
    assert view.is_contiguous() and not hk._aligned(view)
    a, g, f = view.shape
    assert hk.launch_plan(a, g, f, view.dtype, hk._aligned(view), SMS).v == 1
