"""Port parity: a level trained over node shards (``parallel.mesh_nodes``),
one gloo rank a shard, in halo and hypercube mode, on 2 and 3 ranks.

For each run the JAX package's distributed trainer (``train_level`` on a
mesh of the same size) draws the initial parameters; their shard-padding
rows are zeroed (those nodes have no edges and no label, so with zero
parameters they add nothing to the loss, the L2 term or any gradient), and
the same tree is injected into the port's ranks (``tests/torch_dist_worker.py``)
and, cut to the level's own node space, into the port's one-device trainer.
Dropout is 0 (the decoder's too).  Three epochs: the losses agree at
rtol 1e-5; the parameters at rtol 1e-5 with atol 1e-6 x max|leaf| plus
``ADAM_DRIFT`` x lr a step (tests/test_torch_cluster.py: Adam normalises
each element's step, so float32 rounding of a gradient that is a
cancellation residue moves that element by a share of lr); the embeddings
at rtol 1e-5, atol 1e-5.  The hypercube run on 3 ranks trains its node
tables with factored Adafactor moments ([32, 32] dims), whose means over the
node axis run over the ranks; it is held against JAX only (the one-device
trainer factors a hypercube level's rg constant otherwise).  A level cut after 2 epochs and resumed from
its step checkpoint to 4 equals the uncut run bit for bit (halo on 2 ranks;
hypercube with Adafactor on 3).  And the CLI under ``torchrun`` on the CPU
writes the pooled embeddings once.
"""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from protgram_directgcn_torch import convert
from protgram_directgcn_torch.config import Config as TConfig
from protgram_directgcn_torch.graph.builder import NgramGraphBuilder as TBuilder
from protgram_directgcn_torch.graph.structure import load_graph as t_load_graph
from protgram_directgcn_torch.models import directgcn as t_model
from protgram_directgcn_torch.pipeline import trainer as t_trainer
from protgram_directgcn_torch.pipeline.labels import next_node_labels
from protgram_directgcn_torch.utils.io import read_embeddings
from protgram_directgcn_tpu.config import Config as JConfig
from protgram_directgcn_tpu.graph.structure import load_graph as j_load_graph
from protgram_directgcn_tpu.models import directgcn as j_model
from protgram_directgcn_tpu.ops.hypercube import vocab_char_codes
from protgram_directgcn_tpu.pipeline import trainer as j_trainer
from tests import torch_dist_worker as W
from tests.test_torch_graph import write_seeded_fasta

RTOL, ATOL = 1e-5, 1e-6
ADAM_DRIFT = 2e-3
EPOCHS = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: (world size, mode, hidden dims, node_param_factored)
RUNS = {
    "halo_ws2": (2, "halo", [16, 8], "auto"),
    "halo_ws3": (3, "halo", [16, 8], "auto"),
    "hyper_ws2": (2, "hypercube", [16, 8], "auto"),
    "hyper_ws3": (3, "hypercube", [32, 32], "on"),
}


def _set(mode, ws, dims, factored, epochs=EPOCHS):
    return {"gcn.hidden_layer_dims": dims, "gcn.epochs_per_level": epochs,
            "gcn.dropout_rate": 0.0, "gcn.node_param_factored": factored,
            "gcn.checkpoint_every_epochs": 2, "parallel.mesh_nodes": ws, "parallel.mode": mode}


def _pad_rows(graph, total, mode):
    """The rows of the padded node space that belong to no node of the level's
    own space: the shard padding past N (halo), the keys past G (hypercube)."""
    if mode == "halo":
        return np.arange(graph.num_nodes, total)
    codes, a = vocab_char_codes(graph.vocab)
    g = a ** (graph.n - 1)
    gp = total // a
    return (np.arange(a)[:, None] * gp + np.arange(g, gp)[None, :]).reshape(-1)


def _to_level_space(arr, graph, total, mode):
    """Rows of a padded node table in the one-device trainer's node space."""
    if mode == "halo":
        return arr[: graph.num_nodes]
    codes, a = vocab_char_codes(graph.vocab)
    g = a ** (graph.n - 1)
    return arr.reshape((a, total // a) + arr.shape[1:])[:, :g].reshape((a * g,) + arr.shape[1:])


def _map_nodes(tree, fn, total):
    def walk(t):
        if isinstance(t, dict):
            return {k: (fn(v) if k in t_trainer._NODE_PARAM_NAMES and v is not None
                        and np.ndim(v) >= 1 and np.shape(v)[0] == total else walk(v))
                    for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t
    return walk(tree)


def _flat(tree):
    """{i:name: array} in the port's leaf order (``named_leaves``)."""
    return {f"{i}:{k}": (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for i, (k, v) in enumerate(t_model.named_leaves(tree))}


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """The JAX runs, the port's ranks on 2 and 3 processes (one spawn each),
    and the port's one-device runs."""
    d = tmp_path_factory.mktemp("trainer_dist")
    fasta = write_seeded_fasta(d / "seq.fasta", n_seqs=30, lo=10, hi=40)
    paths = TBuilder(n_max=2).run(fasta, d / "graphs")
    jg = j_load_graph(paths[1])
    x = np.random.default_rng(0).normal(size=(jg.num_nodes, 12)).astype(np.float32)
    y, classes = next_node_labels(jg)

    jax_out, runs = {}, {}
    for name, (ws, mode, dims, factored) in RUNS.items():
        captured, losses = {}, []

        def capture_init(key, cfg, _mode=mode):
            params = j_init(key, cfg)
            pad = _pad_rows(jg, cfg.num_nodes, _mode)

            def zero(v):
                v = np.array(v)
                v[pad] = 0
                return v

            host = _map_nodes(jax.tree_util.tree_map(np.array, params), zero, cfg.num_nodes)
            captured.update(params=host, total=cfg.num_nodes)
            return jax.tree_util.tree_map(jax.numpy.asarray, host)

        def step_factory(*a):
            step = j_step(*a)

            def wrapped(*args):
                out = step(*args)
                losses.append(float(out[2]))
                return out
            return wrapped

        j_init, j_step = j_trainer.init_directgcn_params, j_trainer.make_train_step
        cfg = JConfig()
        for k, v in _set(mode, ws, dims, factored).items():
            cfg.apply_overrides({k: v})
        cfg.gcn.checkpoint_every_epochs = 0
        j_trainer.init_directgcn_params, j_trainer.make_train_step = capture_init, step_factory
        j_cfg = j_trainer.DirectGCNConfig
        j_trainer.DirectGCNConfig = lambda **kw: j_model.DirectGCNConfig(**kw, decoder_dropout=0.0)
        try:
            params, emb, _, _ = j_trainer.HierarchicalTrainer(cfg).train_level(jg, x, y, classes)
        finally:
            j_trainer.init_directgcn_params, j_trainer.make_train_step = j_init, j_step
            j_trainer.DirectGCNConfig = j_cfg
        jax_out[name] = {"losses": losses, "embeds": np.asarray(emb), "total": captured["total"],
                         "params": _flat(convert.params_from_jax(
                             jax.tree_util.tree_map(np.array, params), device="cpu"))}
        runs[name] = {"world_size": ws, "graph": paths[1], "x": x, "y": y, "classes": classes,
                      "set": _set(mode, ws, dims, factored), "params": captured["params"]}

    # Cut after 2 epochs and resumed to 4, against 4 uncut epochs.
    for name, base in (("halo_ws2", "halo_ws2"), ("hyper_ws3", "hyper_ws3")):
        ws, mode, dims, factored = RUNS[base]
        for kind, cut in (("uncut", [4]), ("resumed", [2, 4])):
            runs[f"{name}_{kind}"] = dict(runs[base], set=_set(mode, ws, dims, factored, 4),
                                          cut=cut, ckpt_dir=str(d / f"ckpt_{name}_{kind}"))
    with open(d / "runs.pkl", "wb") as fh:
        pickle.dump(runs, fh)
    port = {}
    for ws in (2, 3):
        W.spawn(W.trainer_scenarios, ws, str(d), timeout=300)
        with open(d / "trainer_r0.pkl", "rb") as fh:
            port.update(pickle.load(fh))

    one = {}
    for name, (ws, mode, dims, factored) in RUNS.items():
        total = jax_out[name]["total"]
        tree = _map_nodes(runs[name]["params"], lambda v: _to_level_space(v, jg, total, mode),
                          total)
        cfg = TConfig()
        for k, v in _set(mode, ws, dims, factored).items():
            cfg.apply_overrides({k: v})
        cfg.parallel.mesh_nodes = None
        cfg.gcn.spmm_mode = "ell" if mode == "halo" else "hypercube"
        tr = t_trainer.HierarchicalTrainer(cfg, device="cpu")
        saved = (t_trainer.init_directgcn_params, t_trainer.DirectGCNConfig)
        t_trainer.init_directgcn_params = lambda gen, c, device, _t=tree: \
            convert.params_from_jax(_t, device="cpu")
        t_trainer.DirectGCNConfig = lambda **kw: t_model.DirectGCNConfig(**kw, decoder_dropout=0.0)
        try:
            params, emb, _, _ = tr.train_level(t_load_graph(paths[1]), x, y, classes)
        finally:
            t_trainer.init_directgcn_params, t_trainer.DirectGCNConfig = saved
        one[name] = {"losses": tr.level_stats[jg.n]["losses"], "embeds": emb,
                     "params": _flat(params), "route": tr.level_stats[jg.n]["route"]}
    return {"graph": jg, "jax": jax_out, "port": port, "one": one}


def _params_close(got, ref, steps, what):
    drift = ADAM_DRIFT * 1e-3 * steps
    assert sorted(got) == sorted(ref), what
    for k in ref:
        r = np.asarray(ref[k], np.float64)
        np.testing.assert_allclose(np.asarray(got[k], np.float64).reshape(r.shape), r, rtol=RTOL,
                                   atol=ATOL * max(1.0, float(np.abs(r).max())) + drift,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_level_matches_jax(study, name):
    ws, mode, _, _ = RUNS[name]
    j, p = study["jax"][name], study["port"][name]
    assert p["route"] == ("halo" if mode == "halo" else "hyper_shard")
    assert p["world_size"] == ws
    assert len(p["losses"]) == len(j["losses"]) == EPOCHS
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=RTOL)
    _params_close(p["params"], j["params"], EPOCHS, name)
    np.testing.assert_allclose(p["embeds"], j["embeds"], rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("name", [k for k, v in RUNS.items() if v[3] != "on"])
def test_sharded_level_matches_one_device(study, name):
    """Adam runs only: the one-device trainer stores a hypercube level's
    constant rg [A, G, out], which Adafactor factors otherwise than the
    sharded (and the JAX distributed) flat table."""
    ws, mode, _, _ = RUNS[name]
    jg = study["graph"]
    o, p = study["one"][name], study["port"][name]
    assert o["route"] == ("ell" if mode == "halo" else "hypercube")
    np.testing.assert_allclose(p["losses"], o["losses"], rtol=RTOL)
    np.testing.assert_allclose(p["embeds"], o["embeds"], rtol=RTOL, atol=1e-5)
    total = study["jax"][name]["total"]
    mapped = {}
    for k, v in p["params"].items():
        name_k = k.split(":", 1)[1]
        if name_k in t_trainer._NODE_PARAM_NAMES and v.ndim >= 1 and v.shape[0] == total:
            v = _to_level_space(v, jg, total, mode)
            if name_k == "constant" and o["params"][k].ndim == 3:
                v = v.reshape(o["params"][k].shape)
        mapped[k] = v
    _params_close(mapped, o["params"], EPOCHS, name)


@pytest.mark.parametrize("name", ["halo_ws2", "hyper_ws3"])
def test_cut_and_resumed_level_equals_uncut(study, name):
    uncut, resumed = study["port"][f"{name}_uncut"], study["port"][f"{name}_resumed"]
    assert resumed["start_epoch"] == 3 and len(resumed["losses"]) == 2
    assert resumed["losses"] == uncut["losses"][2:]
    for k in uncut["params"]:
        np.testing.assert_array_equal(resumed["params"][k], uncut["params"][k], err_msg=k)
    np.testing.assert_array_equal(resumed["embeds"], uncut["embeds"])


def test_cli_under_torchrun_on_the_cpu(tmp_path, toy_fasta):
    out = tmp_path / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "protgram_directgcn_torch", "--fasta", str(toy_fasta), "--out", str(out),
           "--stages", "graph,gcn", "--device", "cpu", "--set", "parallel.mesh_nodes=2",
           "--set", "parallel.mode=hypercube", "--set", "graph_builder.ngram_max_n=2",
           "--set", "gcn.hidden_layer_dims=[16,8]", "--set", "gcn.one_gram_init_dim=12",
           "--set", "gcn.epochs_per_level=3", "--set", "gcn.apply_pca=false",
           "--set", "gcn.run_sanity_check_ppi=false", "--set", "id_mapping_mode=none"]
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    emb_dir = out / "2_gcn_embeddings"
    files = [f for f in os.listdir(emb_dir) if f.startswith("gcn_n2_embeddings")]
    assert len(files) == 1, files
    pooled = read_embeddings(str(emb_dir / files[0]))
    assert set(pooled) == {"P001", "P002", "P003"}
    assert all(v.shape == (8,) and np.isfinite(v).all() for v in pooled.values())
    assert "2 node shards" in proc.stderr or "2 node shards" in proc.stdout
