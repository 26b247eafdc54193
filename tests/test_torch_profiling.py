"""Port parity: ``utils/profiling.py`` against the JAX package's.

``StepTimer``'s statistics on a given sequence of step times equal JAX's
exactly (the same arithmetic on the same floats); ``capture_trace`` writes
a Chrome trace that names a ``trace()`` range; the roofline helper equals
JAX's; ``detect_bandwidth`` gives the CPU entry and refuses a card it does
not know.
"""

import json

import numpy as np
import pytest
import torch

from protgram_directgcn_torch.utils import profiling as t_prof
from protgram_directgcn_tpu.utils import profiling as j_prof


@pytest.mark.parametrize("n_times,warmup", [(0, 2), (1, 2), (2, 2), (3, 2), (7, 2), (5, 0),
                                            (6, 4)])
def test_step_timer_statistics_match_jax(n_times, warmup):
    times = list(np.random.default_rng(n_times * 10 + warmup).random(n_times) * 1e-3)
    jt, tt = j_prof.StepTimer(warmup=warmup), t_prof.StepTimer(warmup=warmup)
    jt.times.extend(times)
    tt.times.extend(times)
    assert tt.steady == jt.steady
    for stat in ("mean", "best"):
        j, t = getattr(jt, stat)(), getattr(tt, stat)()
        assert (np.isnan(j) and np.isnan(t)) or j == t, stat


def test_step_timer_records_each_step():
    timer = t_prof.StepTimer(warmup=1)
    for _ in range(3):
        with timer:
            torch.ones(8).sum()
    assert len(timer.times) == 3 and all(t >= 0 for t in timer.times)
    assert timer.best() <= timer.mean()


@pytest.mark.parametrize("feat_dim,bandwidth,dtype_bytes", [(64, 5e10, 4), (256, 3.35e12, 2),
                                                            (7, 8.19e11, 4)])
def test_roofline_matches_jax(feat_dim, bandwidth, dtype_bytes):
    assert (t_prof.spmm_roofline_edges_per_s(feat_dim, bandwidth, dtype_bytes)
            == j_prof.spmm_roofline_edges_per_s(feat_dim, bandwidth, dtype_bytes))


def test_capture_trace_names_the_trace_range(tmp_path):
    with t_prof.capture_trace(tmp_path / "prof", device="cpu") as prof:
        with t_prof.trace("zoo_forward", log=True):
            (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    path = tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "zoo_forward" for e in events)
    busy = t_prof.device_busy(prof, 1.0)
    assert busy["busy_share"] is None and busy["wall_seconds"] == 1.0


def test_detect_bandwidth(monkeypatch):
    assert t_prof.detect_bandwidth("cpu") == j_prof.HBM_BANDWIDTH["cpu"]
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert t_prof.detect_bandwidth("cuda") == 3.35e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "Some Other Card")
    with pytest.raises(ValueError, match="Some Other Card"):
        t_prof.detect_bandwidth("cuda")
