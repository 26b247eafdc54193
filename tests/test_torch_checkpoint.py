"""Port parity: the in-level training checkpoints and the metric log.

- ``utils/checkpoint``: a save/restore round trip of the parameters and the
  optimizer's state (Adam, factored Adafactor with bf16 node tables) equal
  bit for bit, the state's float32 moments kept float32; the latest
  ``step_{k}`` wins; a checkpoint of other shapes is refused;
- a level cut at epoch 4 (``checkpoint_every_epochs=2``) and resumed to 6
  ends with parameters ``torch.equal`` to an uncut 6-epoch run, with the
  default dropout (the generator's state rides in the checkpoint), under
  Adam (tier 0) and under factored Adafactor (tier 3, and the staged step
  of tier 4);
- ``utils/metrics``: ``MetricLogger`` and ``read_metrics`` write and read
  what the JAX package's do, record for record but the time;
- ``run()`` at n = 1..2 with the JAX package's initial parameters, dropout
  0: the port's ``level_checkpoints/run_n{n}`` files agree with the JAX
  ``run()``'s key for key and line for line, losses at the three-step parity
  tolerance (rtol 1e-4).
"""

import json

import jax
import numpy as np
import pytest
import torch

from protgram_directgcn_torch import convert
from protgram_directgcn_torch.config import Config as TConfig
from protgram_directgcn_torch.graph.builder import NgramGraphBuilder as TBuilder
from protgram_directgcn_torch.models import directgcn as t_model
from protgram_directgcn_torch.pipeline import trainer as t_trainer
from protgram_directgcn_torch.utils import checkpoint as t_ckpt
from protgram_directgcn_torch.utils import metrics as t_metrics
from protgram_directgcn_torch.utils.io import parse_fasta
from protgram_directgcn_tpu.config import Config as JConfig
from protgram_directgcn_tpu.graph.builder import NgramGraphBuilder as JBuilder
from protgram_directgcn_tpu.models import directgcn as j_model
from protgram_directgcn_tpu.pipeline import trainer as j_trainer
from protgram_directgcn_tpu.utils import metrics as j_metrics
from tests.test_torch_graph import write_seeded_fasta


@pytest.fixture(scope="module")
def level(tmp_path_factory):
    fasta = write_seeded_fasta(tmp_path_factory.mktemp("ckpt") / "seq.fasta", n_seqs=60,
                               lo=30, hi=90)
    return TBuilder(n_max=2).build_from_sequences(list(parse_fasta(fasta)))[1]


def _tree(factored: bool):
    cfg = t_model.DirectGCNConfig(layer_dims=(6, 8, 4), num_nodes=40, num_classes=3,
                                  n_gram_len=2, node_param_dtype="bfloat16")
    params = t_model.init_directgcn_params(torch.Generator().manual_seed(0), cfg, "cpu")
    for p in t_model.param_leaves(params):
        p.requires_grad_(True)
    opt = t_trainer.make_optimizer(params, 1e-2, 1e-3,
                                   factor_node_params_above=40 if factored else None)
    return params, opt


def _steps(params, opt, seed: int, steps: int = 2):
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for p in t_model.param_leaves(params):
            p.grad = torch.randn(p.shape, generator=gen).to(p.dtype)
        opt.step()


@pytest.mark.parametrize("factored", [False, True])
def test_round_trip(tmp_path, factored):
    params, opt = _tree(factored)
    _steps(params, opt, 1)
    opt.param_groups[0]["lr"] = 3e-3
    t_ckpt.save_train_state(tmp_path, 2, params, opt, {"tag": torch.arange(3)})
    _steps(params, opt, 2)
    t_ckpt.save_train_state(tmp_path, 4, params, opt, {"tag": torch.arange(4)})
    assert t_ckpt.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_4"]

    fresh, fresh_opt = _tree(factored)
    step, extra = t_ckpt.restore_train_state(tmp_path, fresh, fresh_opt)
    assert step == 4 and torch.equal(extra["tag"], torch.arange(4))
    kinds = {g["kind"] for g in fresh_opt.param_groups}
    assert kinds == ({"adam", "adafactor"} if factored else {"adam"})
    assert [g["lr"] for g in fresh_opt.param_groups] == [g["lr"] for g in opt.param_groups]
    for a, b in zip(t_model.param_leaves(fresh), t_model.param_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
        sa, sb = fresh_opt.state[a], opt.state[b]
        assert sa.keys() == sb.keys() and sa
        for k in sa:
            if isinstance(sb[k], torch.Tensor):
                assert sa[k].dtype == torch.float32 and torch.equal(sa[k], sb[k]), k
            else:
                assert sa[k] == sb[k]
    # The next update from the restored state is the saved run's.
    _steps(fresh, fresh_opt, 3, steps=1)
    _steps(params, opt, 3, steps=1)
    for a, b in zip(t_model.param_leaves(fresh), t_model.param_leaves(params)):
        assert torch.equal(a, b)


def test_restore_refuses_other_shapes(tmp_path):
    params, opt = _tree(False)
    assert t_ckpt.restore_train_state(tmp_path / "none", params, opt) is None
    t_ckpt.save_train_state(tmp_path, 1, params, opt)
    cfg = t_model.DirectGCNConfig(layer_dims=(6, 4), num_nodes=40, num_classes=3, n_gram_len=2)
    other = t_model.init_directgcn_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert t_ckpt.restore_train_state(tmp_path, other,
                                      t_trainer.make_optimizer(other, 1e-2, 0.0)) is None


def _trainer(epochs: int, tier: int, level) -> t_trainer.HierarchicalTrainer:
    tt = t_trainer.HierarchicalTrainer(TConfig(), device="cpu")
    tt.gcn.hidden_layer_dims = [16, 8]
    tt.gcn.epochs_per_level = epochs
    tt.gcn.checkpoint_every_epochs = 2
    tt.gcn.use_early_stopping = False
    if tier:
        _, alpha = t_trainer.vocab_char_codes(level.vocab)
        cd, nd, rm, fc, rp = t_trainer.TIER_LEVERS[tier]
        need = sum(tt._residency(alpha**level.n, 12, 5, cd, nd, rm, fc, rp,
                                 staged=tier == 4))
        tt._hbm_override = need + tt._PLAN_SLACK + tt._MIN_BANK
    return tt


@pytest.mark.parametrize("tier", [0, 3, 4])
def test_cut_and_resumed_level_equals_the_uncut_one(tmp_path, level, tier):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(level.num_nodes, 12)).astype(np.float32)
    y = rng.integers(0, 5, level.num_nodes).astype(np.int64)
    cut = _trainer(4, tier, level)
    cut.train_level(level, x, y, 5, ckpt_dir=tmp_path / "cut")
    assert sorted(p.name for p in (tmp_path / "cut").iterdir()) == ["step_2", "step_4"]
    resumed = _trainer(6, tier, level)
    params, *_ = resumed.train_level(level, x, y, 5, ckpt_dir=tmp_path / "cut")
    st = resumed.level_stats[2]
    assert st["start_epoch"] == 5 and st["epochs"] == 2 and st["plan"]["tier"] == tier
    assert st["staged"] == (tier == 4)
    uncut = _trainer(6, tier, level)
    ref, *_ = uncut.train_level(level, x, y, 5, ckpt_dir=tmp_path / "uncut")
    assert uncut.level_stats[2]["start_epoch"] == 1
    np.testing.assert_array_equal(st["losses"], uncut.level_stats[2]["losses"][4:])
    for a, b in zip(t_model.param_leaves(params), t_model.param_leaves(ref)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_metric_logger_matches_jax(tmp_path):
    records = [({"level": 2, "loss": 1.5, "lr": 1e-3}, 1), ({"level": 2, "loss": np.float32(1.25),
                                                            "lr": 5e-4}, 2), ({"note": "x"}, None)]
    out = {}
    for name, mod in (("port", t_metrics), ("jax", j_metrics)):
        with mod.MetricLogger(tmp_path / name, "gcn_n2") as log:
            log.log_params({"level": 2, "task": "next_node", "num_nodes": 7})
            for metrics, step in records:
                log.log_metrics(metrics, step=step)
            log.log_artifact("emb", tmp_path / "emb.h5")
        out[name] = ([{k: v for k, v in r.items() if k != "t"}
                      for r in mod.read_metrics(tmp_path / name)],
                     (tmp_path / name / "params.json").read_text(),
                     json.loads((tmp_path / name / "artifacts.json").read_text()))
    assert out["port"] == out["jax"]
    assert t_metrics.read_metrics(tmp_path / "absent") == []


def test_run_writes_the_jax_metric_logs(tmp_path, monkeypatch):
    fasta = write_seeded_fasta(tmp_path / "seq.fasta", n_seqs=50, lo=30, hi=80)
    sets = {"gcn.hidden_layer_dims": [12, 8], "gcn.one_gram_init_dim": 8,
            "gcn.epochs_per_level": 3, "gcn.run_sanity_check_ppi": False,
            "gcn.dropout_rate": 0.0, "gcn.apply_pca": False, "gcn.use_early_stopping": False,
            "graph_builder.ngram_max_n": 2}
    captured = {}
    j_init = j_model.init_directgcn_params

    def capture(key, cfg):
        params = j_init(key, cfg)
        captured[cfg.n_gram_len] = jax.tree_util.tree_map(np.array, params)
        return params

    monkeypatch.setattr(j_trainer, "init_directgcn_params", capture)
    monkeypatch.setattr(t_trainer, "init_directgcn_params",
                        lambda gen, cfg, device: convert.params_from_jax(
                            captured[cfg.n_gram_len], device="cpu"))
    for mod, pkg in ((j_trainer, j_model), (t_trainer, t_model)):
        monkeypatch.setattr(mod, "DirectGCNConfig",
                            lambda _cls=pkg.DirectGCNConfig, **kw: _cls(**kw, decoder_dropout=0.0))
    dirs = {}
    for name, config, builder, trainer in (
            ("jax", JConfig(), JBuilder, lambda c: j_trainer.HierarchicalTrainer(c)),
            ("port", TConfig(), TBuilder,
             lambda c: t_trainer.HierarchicalTrainer(c, device="cpu"))):
        config.apply_overrides(sets)
        config.paths.input_fasta = fasta
        config.paths.base_output_dir = tmp_path / name
        builder(config).run()
        trainer(config).run()
        dirs[name] = config.paths.gcn_embeddings_dir / "level_checkpoints"
    for n in (1, 2):
        j_dir, t_dir = dirs["jax"] / f"run_n{n}", dirs["port"] / f"run_n{n}"
        assert sorted(p.name for p in t_dir.iterdir()) == sorted(p.name for p in j_dir.iterdir())
        assert (json.loads((t_dir / "params.json").read_text())
                == json.loads((j_dir / "params.json").read_text()))
        got, want = t_metrics.read_metrics(t_dir), j_metrics.read_metrics(j_dir)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            assert {k: g[k] for k in ("run", "step", "level", "lr")} == {
                k: w[k] for k in ("run", "step", "level", "lr")}
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
