"""The reference held against the program on the CPU at a small size: the
graph and the operators against the program's ETL and transforms, the node
space against the hypercube layout, and whole runs of each cell, sound and
with a fault planted in the program's timed path, which ``correct`` has to
catch."""

import numpy as np
import pytest
import torch

from perfbench.lib import corpus, manifest, runner
from perfbench.reference import graph as ref_graph

BENCH = manifest.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
# A small corpus whose n = 3 level takes the hypercube under "auto".
MIX = {"corpus": {"sequences": 200, "min_length": 20, "max_length": 80, "data_seed": 5},
       "n": 3, "feat_dim": 16, "num_classes": 4}


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("perfbench_cache")


@pytest.fixture(scope="module")
def files(cache):
    return corpus.level_files(MIX, cache)


@pytest.fixture(scope="module")
def seqs(files):
    from protgram_directgcn_torch.utils.io import parse_fasta

    ours = ref_graph.read_fasta(str(files[0]))
    assert ours == [s for _, s in parse_fasta(files[0])]
    return ours


@pytest.mark.parametrize("n", [1, 2, 3])
def test_graph_matches_the_program_etl(seqs, n):
    from protgram_directgcn_torch.graph.builder import NgramGraphBuilder

    port = NgramGraphBuilder(n_max=n, use_native=False).build_from_sequences(
        [("p", s) for s in seqs])[-1]
    ours = ref_graph.ngram_graph(seqs, n)
    chars = np.ascontiguousarray(ours.chars().to(torch.uint8).numpy())
    np.testing.assert_array_equal(chars.view(f"S{n}").ravel().astype(f"U{n}"), port.vocab)
    np.testing.assert_array_equal(ours.src.numpy(), port.src)
    np.testing.assert_array_equal(ours.tgt.numpy(), port.tgt)
    np.testing.assert_array_equal(ours.weight.numpy(), port.weight)


def test_operators_match_the_program_transforms(seqs):
    from protgram_directgcn_torch.graph import transforms
    from protgram_directgcn_torch.graph.builder import NgramGraphBuilder

    port = NgramGraphBuilder(n_max=3, use_native=False).build_from_sequences(
        [("p", s) for s in seqs])[-1]
    ours = ref_graph.operators(ref_graph.ngram_graph(seqs, 3), port.epsilon_propagation)
    mats = (port.mathcal_a_in(), port.mathcal_a_out(), port.undirected_norm())
    for (src, tgt, w), m in zip(ours, mats):
        ps, pt, pw = transforms.csr_to_coo_arrays(m)
        np.testing.assert_array_equal(src.numpy(), ps)
        np.testing.assert_array_equal(tgt.numpy(), pt)
        np.testing.assert_allclose(w.numpy(), pw, rtol=1e-6, atol=0)


def test_hypercube_positions_match_the_program_layout(seqs):
    from protgram_directgcn_torch.graph.builder import NgramGraphBuilder
    from protgram_directgcn_torch.ops.hypercube import vocab_char_codes

    port = NgramGraphBuilder(n_max=3, use_native=False).build_from_sequences(
        [("p", s) for s in seqs])[-1]
    codes, alpha = vocab_char_codes(port.vocab)
    positions, size = ref_graph.ngram_graph(seqs, 3).hypercube_positions()
    np.testing.assert_array_equal(positions.numpy(), codes @ (alpha ** np.arange(2, -1, -1)))
    assert size == alpha ** 3


def _run(cell, cache, seed=2**33 + 5, traced=False):
    return runner.run_cell(BENCH, manifest.workload(BENCH, cell), seed, 0.2, traced,
                           torch.device("cpu"), cache_root=cache, mix=MIX)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, cache):
    r = _run(cell, cache)
    assert r["correct"], r
    assert list(r)[-1] == "compared"
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert {"step_ms", "setup_s"} <= set(r["metrics"])
    for c in r["compared"].values():
        assert c["value"] <= c["limit"] / 10


def test_traced_run_is_correct_and_reads_the_host_metric(cache):
    r = _run(CELLS[0], cache, seed=77, traced=True)
    assert r["correct"], r
    assert "level_start_s" in r["metrics"] and "step_ms" not in r["metrics"]


@pytest.mark.parametrize("stated,forced", [("bfloat16", "auto"), ("float32", "bfloat16")])
def test_run_in_another_precision_than_stated_gives_no_result(stated, forced, cache, tmp_path):
    """The plan's compute type is read from the trainer: a configuration whose
    ``precision`` the level did not run in raises before any result."""
    import copy
    import json

    bench = copy.deepcopy(BENCH)
    entry = bench["configs"][0]
    cfg = manifest.config(BENCH, entry["name"])
    cfg["precision"] = stated
    cfg["gcn"]["compute_dtype"] = forced
    entry["file"] = str(tmp_path / "config.json")
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    cell = next(w for w in bench["workloads"] if w["config"] == entry["name"])
    with pytest.raises(ValueError, match="plan computes in"):
        runner.run_cell(bench, cell, 3, 0.2, False, torch.device("cpu"), cache_root=cache,
                        mix=MIX)


def _unchanged_state(monkeypatch):
    from protgram_directgcn_torch.pipeline import trainer

    monkeypatch.setattr(trainer.TrainOptimizer, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from protgram_directgcn_torch.pipeline import trainer

    masked_nll = trainer._masked_nll

    def half(log_sm, y, mask):
        kept = mask.clone().reshape(-1)
        kept[torch.nonzero(kept)[::2, 0]] = 0.0
        return masked_nll(log_sm, y, kept.reshape(mask.shape))

    monkeypatch.setattr(trainer, "_masked_nll", half)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_reads_not_correct(cell, fault, cache, monkeypatch):
    fault(monkeypatch)
    r = _run(cell, cache)
    assert r["correct"] is False, r["compared"]
