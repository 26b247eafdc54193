"""Port parity: the benchmark datasets (``bench/datasets.py``) against the
JAX package's.

- the raw-format fixtures under ``tests/data`` (Planetoid: Cora, CiteSeer
  with its isolated test nodes, PubMed; WebKB: Cornell, Texas, Wisconsin)
  parsed by both packages: every array byte-equal, and equal to the
  fixtures' ``*_truth.npz``;
- the six synthetic stand-ins byte-equal to JAX's within this process (both
  seed them by ``seed + hash(name) % 1000``, which Python salts per
  process);
- ``karate_club()`` equal to the JAX one, which reads networkx (imported by
  this test only), and to networkx's graph itself;
- ``undirected()`` and ``load_dataset``'s choice and warning.
"""

import logging
import os

import networkx as nx
import numpy as np
import pytest

from protgram_directgcn_torch.bench import datasets as t_data
from protgram_directgcn_torch.utils.io import logger as t_logger
from protgram_directgcn_tpu.bench import datasets as j_data

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIELDS = ("x", "edge_index", "y", "train_mask", "val_mask", "test_mask")
PLANETOID = ["Cora", "CiteSeer", "PubMed"]
WEBKB = ["Cornell", "Texas", "Wisconsin"]


def _truth(name):
    with np.load(os.path.join(DATA, f"{name}_truth.npz")) as z:
        return {k: z[k] for k in z.files}


def _assert_same(t, j):
    assert (t.name, t.synthetic) == (j.name, j.synthetic)
    for f in FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        if b is None:
            assert a is None, f
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("name", PLANETOID + WEBKB)
def test_fixture_parsers_byte_equal_to_jax_and_truth(name):
    parse = "_parse_planetoid" if name in PLANETOID else "_parse_webkb"
    t = getattr(t_data, parse)(DATA, name)
    j = getattr(j_data, parse)(DATA, name)
    assert t is not None and not t.synthetic
    _assert_same(t, j)
    truth = _truth(name)
    np.testing.assert_array_equal(t.x, truth["x"])
    np.testing.assert_array_equal(t.y, truth["y"])
    np.testing.assert_array_equal(np.unique(t.edge_index.T, axis=0), truth["edges"])
    if name in PLANETOID:
        n_train = int(truth["n_train"])
        assert t.train_mask[:n_train].all() and not t.train_mask[n_train:].any()
        want = np.zeros(len(truth["y"]), bool)
        want[truth["test_index"]] = True
        np.testing.assert_array_equal(t.test_mask, want)
    if name == "CiteSeer":
        assert (t.x[9] == 0).all()  # the isolated test node


@pytest.mark.parametrize("name", sorted(t_data._SYNTH_SHAPES))
@pytest.mark.parametrize("seed", [42, 7])
def test_stand_ins_byte_equal_to_jax(name, seed):
    t = t_data.synthetic_stand_in(name, seed)
    _assert_same(t, j_data.synthetic_stand_in(name, seed))
    spec = t_data._SYNTH_SHAPES[name]
    assert t.synthetic and t.x.shape == (spec["n"], min(spec["f"], 256))
    assert t.num_classes <= spec["c"]
    assert (t.edge_index[0] != t.edge_index[1]).all()


def test_unknown_name_stand_in_matches_jax():
    _assert_same(t_data.synthetic_stand_in("Other", 3), j_data.synthetic_stand_in("Other", 3))


def test_karate_club_equals_networkx_and_jax():
    t = t_data.karate_club()
    _assert_same(t, j_data.karate_club())
    g = nx.karate_club_graph()
    assert t.num_nodes == g.number_of_nodes() == 34 and t.num_classes == 2
    assert list(map(tuple, t.edge_index.T[:78].tolist())) == list(g.edges())
    assert t_data.KARATE_EDGES == tuple(g.edges())
    assert [int(v) for v in t.y] == [0 if g.nodes[i]["club"] == "Mr. Hi" else 1
                                     for i in range(34)]


@pytest.mark.parametrize("name", ["karate", "Cora", "Texas", "Cornell-standin"])
def test_undirected_matches_jax(name):
    if name == "karate":
        t, j = t_data.karate_club(), j_data.karate_club()
    elif name == "Cornell-standin":
        t, j = t_data.synthetic_stand_in("Cornell"), j_data.synthetic_stand_in("Cornell")
    else:
        parse = "_parse_planetoid" if name in PLANETOID else "_parse_webkb"
        t, j = getattr(t_data, parse)(DATA, name), getattr(j_data, parse)(DATA, name)
    tu, ju = t.undirected(), j.undirected()
    _assert_same(tu, ju)
    pairs = set(map(tuple, tu.edge_index.T.tolist()))
    assert all((b, a) in pairs for a, b in pairs)


def test_load_dataset_choice_and_warning(tmp_path, caplog):
    assert not t_data.load_dataset("Cora", root=DATA).synthetic
    assert not t_data.load_dataset("Texas", root=DATA).synthetic
    assert t_data.load_dataset("KarateClub", root=tmp_path).name == "KarateClub"
    t_logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING):
            ds = t_data.load_dataset("PubMed", root=tmp_path)
    finally:
        t_logger.removeHandler(caplog.handler)
    assert ds.synthetic
    assert any("synthetic stand-in" in r.getMessage() for r in caplog.records)
    _assert_same(ds, j_data.load_dataset("PubMed", root=tmp_path))
