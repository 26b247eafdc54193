"""The readers of the program's spans (``operator_build_s``,
``first_epoch_s``, ``host_step_ms``, ``loss_wait_ms``) on stub stores:
None on an empty store, on a run with no trace and on a program without
spans; the span's duration, or the median of its recordings, otherwise."""

import types

import pytest

from perfbench.lib import manifest
from protgram_directgcn_torch.utils import profiling

TRACED = types.SimpleNamespace(trace=object())
READERS = ("operator_build_s", "first_epoch_s", "host_step_ms", "loss_wait_ms")


def _store(*spans):
    """Spans as (name, start_ms, end_ms); an end of None is still open."""
    return [profiling.Span(name, -1, int(a * 1e6), -1 if b is None else int(b * 1e6))
            for name, a, b in spans]


@pytest.fixture
def store(monkeypatch):
    held = []
    monkeypatch.setattr(profiling, "spans", lambda: held)
    return held


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_in_an_empty_store(name, store):
    reader = manifest.metric_reader(name)
    assert reader.read(TRACED) is None
    store.extend(_store(("other", 0, 5), (reader.SPAN, 0, None)))
    assert reader.read(TRACED) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_a_trace_or_without_spans(name, store, monkeypatch):
    reader = manifest.metric_reader(name)
    store.extend(_store((reader.SPAN, 0, 5)))
    assert reader.read(types.SimpleNamespace(trace=None)) is None
    monkeypatch.delattr(profiling, "spans")  # a program that records no spans
    assert reader.read(TRACED) is None


@pytest.mark.parametrize("name", ["operator_build_s", "first_epoch_s"])
def test_setup_readers_give_the_span_in_seconds(name, store):
    reader = manifest.metric_reader(name)
    store.extend(_store(("level.plan", 0, 1), (reader.SPAN, 1, 2501), ("step", 2600, 2630)))
    assert reader.read(TRACED) == pytest.approx(2.5)


@pytest.mark.parametrize("name", ["host_step_ms", "loss_wait_ms"])
def test_step_readers_give_the_median_in_ms(name, store):
    reader = manifest.metric_reader(name)
    store.extend(_store((reader.SPAN, 0, 4), ("epoch", 0, 40), (reader.SPAN, 10, 12),
                        (reader.SPAN, 20, 29), (reader.SPAN, 30, None)))
    assert reader.read(TRACED) == pytest.approx(4.0)
