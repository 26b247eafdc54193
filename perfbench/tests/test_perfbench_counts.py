"""The operation and byte counts behind ``mfu``, ``roofline.k1k2`` and
``roofline.ell``, against shapes worked by hand."""

import dataclasses

import pytest

from perfbench.lib import counts

SHAPE = counts.StepShape(rows=10, layer_dims=(4, 8, 8), num_classes=3, nnz=(20, 20, 30),
                         dtype="float32")


def test_projection_flops():
    # Layer 0 (4 -> 8): three paths and the residual, forward and weight
    # gradient: 4 * 2 * (2 * 10 * 4 * 8) = 5,120.  Layer 1 (8 -> 8): three
    # paths, no residual projection, three passes: 3 * 3 * 1,280 = 11,520.
    assert counts.projection_flops(SHAPE) == 5120 + 11520


def test_decoder_flops():
    # 8 -> 4 -> 3 over 10 rows, forward and both gradients: 3 * 2 * 10 * 44.
    assert counts.decoder_flops(SHAPE) == 2640


def test_propagation_flops_and_products():
    # Per layer each operator forward and backward: 4 * width * (20 + 20 + 30).
    assert counts.propagation_flops(SHAPE) == 2 * 4 * 8 * 70
    assert len(counts.propagation_products(SHAPE)) == 12
    assert counts.step_flops(SHAPE) == 16640 + 2640 + 4480


def test_product_bytes():
    # x in and out (2 * 10 * 8 * 4) and 20 nonzeros of weight and index.
    assert counts.product_bytes(10, 8, 20, 4, 4) == 640 + 160
    assert counts.product_bytes(10, 8, 20, 4, 0) == 640 + 80
    assert counts.product_bytes(10, 8, 20, 2, 0) == 320 + 80


def test_least_seconds_takes_the_larger_bound():
    peaks = {"bytes_per_s": 100.0, "float32": 1000.0}
    # Each of the 12 products: bytes (640 + 8 * nnz) / 100 against
    # 16 * nnz / 1000 operations: bytes bound every one.
    want = sum((640 + 8 * nnz) / 100.0 for nnz in (20, 20, 30)) * 2 * 2
    assert counts.propagation_least_seconds(SHAPE, 4, peaks) == pytest.approx(want)
    fast_memory = {"bytes_per_s": 1e9, "float32": 1.0}
    want = sum(16 * nnz for nnz in (20, 20, 30)) * 2 * 2
    assert counts.propagation_least_seconds(SHAPE, 4, fast_memory) == pytest.approx(want)


def test_bfloat16_step_counts_two_byte_rows_at_its_own_peak():
    half = dataclasses.replace(SHAPE, dtype="bfloat16")
    assert half.itemsize == 2 and SHAPE.itemsize == 4
    peaks = {"bytes_per_s": 100.0, "float32": 1000.0, "bfloat16": 1e6}
    # Bytes bound every product: rows of 2 bytes, weights and indices of 4.
    want = sum((320 + 8 * nnz) / 100.0 for nnz in (20, 20, 30)) * 2 * 2
    assert counts.propagation_least_seconds(half, 4, peaks) == pytest.approx(want)
    fast_memory = {"bytes_per_s": 1e9, "float32": 1.0, "bfloat16": 2.0}
    want = sum(16 * nnz for nnz in (20, 20, 30)) * 2 * 2 / 2.0
    assert counts.propagation_least_seconds(half, 4, fast_memory) == pytest.approx(want)
    with pytest.raises(KeyError):
        dataclasses.replace(SHAPE, dtype="float16").itemsize


def test_peaks():
    h100 = counts.peaks_for("NVIDIA H100 80GB HBM3")
    assert h100 == {"float32": 67e12, "bfloat16": 989e12, "bytes_per_s": 3.35e12}
    with pytest.raises(ValueError):
        counts.peaks_for("a card with no entry")


def test_full_size_step_is_a_fifth_of_a_teraflop():
    # The n = 4 level: most of a step is the projections (~0.21 TFLOP).
    s = counts.StepShape(rows=167325, layer_dims=(64, 256, 128, 64), num_classes=4,
                         nnz=(6_000_000,) * 3, dtype="float32")
    assert 0.2e12 < counts.projection_flops(s) < 0.22e12
    assert 0.2e12 < counts.step_flops(s) < 0.3e12
