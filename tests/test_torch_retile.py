"""Port parity: the retile pack/unpack (ops/retile.py) against the Pallas
kernels of protgram_directgcn_tpu/ops/pallas_retile.py in interpret mode,
as tests/test_retile.py runs them, and ``pack_rg_carry``/``unpack_rg_carry``
against the JAX model's.

Pure data movement: values and gradients must be equal, bit for bit, in
float32 and bfloat16 (inputs made with numpy from a seed, bf16 carried as
its bits).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from protgram_directgcn_torch.convert import _tensor
from protgram_directgcn_torch.models import directgcn as t_model
from protgram_directgcn_torch.ops import retile
from protgram_directgcn_tpu.models import directgcn as j_model
from protgram_directgcn_tpu.ops.pallas_retile import pack_rg_pallas, unpack_pad_rg_pallas

WIDTHS = [8, 16, 32, 64]
DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
A, GP = 3, 6  # planes and packed rows


def _data(shape, dtype, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(DTYPES[dtype])


def _same(t: torch.Tensor, j) -> None:
    """Bitwise equality of a port tensor and a JAX/numpy array."""
    got = t.detach().float().numpy()
    want = np.asarray(j).astype(np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("kind", ["unpack", "pack_exact", "pack_padded"])
def test_plain_matches_pallas(kind, f, dtype):
    k = 128 // f
    if kind == "unpack":
        x = _data((A, GP, 128), dtype, f)
        _same(retile.unpack(_tensor(x, "cpu"), f), unpack_pad_rg_pallas(jnp.asarray(x), f, True))
    else:
        x = _data((A, GP * k, f if kind == "pack_exact" else 128), dtype, f + 1)
        _same(retile.pack(_tensor(x, "cpu"), f), pack_rg_pallas(jnp.asarray(x), f, True))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("kind", ["unpack", "pack_exact", "pack_padded"])
def test_vjps_match_pallas(kind, f, dtype):
    """Each autograd Function's backward (the other kernel) against the JAX
    custom VJP, on a random cotangent."""
    k = 128 // f
    if kind == "unpack":
        x = _data((A, GP, 128), dtype, 2 * f)
        ct = _data((A, GP * k, 128), dtype, 2 * f + 1)
        fn_t, fn_j = retile.unpack_pad_rg, unpack_pad_rg_pallas
    else:
        lanes = f if kind == "pack_exact" else 128
        x = _data((A, GP * k, lanes), dtype, 3 * f)
        ct = _data((A, GP, 128), dtype, 3 * f + 1)
        fn_t, fn_j = retile.pack_rg, pack_rg_pallas
    _, vjp = jax.vjp(lambda t: fn_j(t, f, True), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(ct))
    xt = _tensor(x, "cpu").requires_grad_(True)
    out = fn_t(xt, f)
    out.backward(_tensor(ct, "cpu"))
    assert xt.grad.dtype == xt.dtype
    _same(xt.grad, dx_j)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("f,g", [(8, 17), (16, 13), (32, 10), (64, 11), (64, 8)])
def test_carry_pack_unpack_match_jax(f, g, dtype):
    """The model's carry helpers, G padded with zeros to a multiple of k and
    cut back on the way out; and their gradient round trip."""
    x = _data((A, g, f), dtype, g)
    packed_j = j_model.pack_rg_carry(jnp.asarray(x))
    xt = _tensor(x, "cpu").requires_grad_(True)
    packed_t = t_model.pack_rg_carry(xt)
    _same(packed_t, packed_j)
    back_t = t_model.unpack_rg_carry(packed_t, f, g)
    _same(back_t, j_model.unpack_rg_carry(packed_j, f, g))
    _same(back_t, x)
    ct = _data((A, g, f), dtype, g + 1)
    back_t.backward(_tensor(ct, "cpu"))
    _same(xt.grad, ct)


@pytest.mark.parametrize("shape", [(A, 5, 128), (A, 4, 200)])
def test_carry_helpers_leave_other_widths(shape):
    """Widths that are not a retile width stay unpacked, and an unpacked
    carry passes the unpack as it is."""
    x = torch.randn(shape)
    x = x[..., :100] if shape[-1] == 200 else x
    assert t_model.pack_rg_carry(x) is x
    assert t_model.unpack_rg_carry(x, x.shape[-1], x.shape[1]) is x
    assert t_model.pack_rg_carry(torch.randn(A, 6, 64), active=False).shape == (A, 6, 64)


def test_wrappers_check_their_inputs():
    with pytest.raises(ValueError, match="width"):
        retile.pack(torch.zeros(A, 32, 4), 4)
    with pytest.raises(ValueError, match="multiple of k"):
        retile.pack(torch.zeros(A, 3, 64), 64)
    with pytest.raises(ValueError, match="wide"):
        retile.pack(torch.zeros(A, 4, 96), 32)
    with pytest.raises(ValueError, match="128 wide"):
        retile.unpack(torch.zeros(A, 4, 64), 64)
    with pytest.raises(TypeError, match="dtype"):
        retile.unpack(torch.zeros(A, 4, 128, dtype=torch.float16), 64)
    with pytest.raises(ValueError, match="contiguous"):
        retile.unpack(torch.zeros(A, 128, 4).transpose(1, 2), 64)


def test_wrappers_never_fall_back_off_cpu():
    x = torch.zeros(A, 4, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        retile.unpack(x, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        retile.pack(x, 64)


def test_cpu_calls_count_no_launch():
    retile.reset_launches()
    x = torch.randn(A, 4, 128, requires_grad=True)
    retile.pack_rg(retile.unpack_pad_rg(x, 32), 32).sum().backward()
    assert retile.launch_counts() == {"pack": {"fwd": 0, "bwd": 0},
                                      "unpack": {"fwd": 0, "bwd": 0}}
    assert torch.equal(x.grad, torch.ones_like(x))
