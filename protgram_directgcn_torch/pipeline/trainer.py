"""Hierarchical DirectGCN trainer: per-n-gram-level training with feature
cascading and protein pooling.

Port of protgram_directgcn_tpu/pipeline/trainer.py:54-110, 138-237,
1271-1374, 1455-1634, 1816-2182 (reference:
src/pipeline/protgram_directgcn_trainer.py:68-426) for the full-batch,
single-device, tier-0 plan: float32 compute, float32 node parameters, no
remat, Adam.  Under ``gcn.spmm_mode="auto"`` levels n >= 2 whose character
hypercube is at most 4x the vocabulary train on the K1/K2 hypercube
operators, and the others on the format ``spmm.build_adjacency`` picks (the
n = 1 level: dense).  ``spmm_mode="pallas"`` trains every level on ELL
operators through the CUDA ELL kernels.

Not ported yet (ROADMAP Queue 1): the memory tiers 1-4 (remat, bf16 node
parameters, factored moments, the staged step), cluster training, the
in-training checkpoint/resume, and the H5/PCA export and PPI sanity check
after pooling.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from protgram_directgcn_torch.config import Config
from protgram_directgcn_torch.graph.structure import DeviceGraph, NgramGraph, load_graph
from protgram_directgcn_torch.models.directgcn import (
    DirectGCNConfig,
    directgcn_apply,
    init_directgcn_params,
    param_leaves,
)
from protgram_directgcn_torch.ops import ell_kernels, hyper_kernels
from protgram_directgcn_torch.ops.hypercube import BlockStructureError, vocab_char_codes
from protgram_directgcn_torch.pipeline.labels import generate_labels
from protgram_directgcn_torch.utils import embeddings as emb_utils
from protgram_directgcn_torch.utils.device import resolve_device
from protgram_directgcn_torch.utils.io import (
    ensure_dir,
    generate_regex_id_map,
    logger,
    parse_fasta,
)


class PlateauScheduler:
    """ReduceLROnPlateau with torch defaults (mode=min, rel threshold 1e-4)
    (reference: protgram_directgcn_trainer.py:84)."""

    def __init__(self, lr: float, patience: int, factor: float, threshold: float = 1e-4):
        self.lr = lr
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, loss: float) -> float:
        if loss < self.best * (1.0 - self.threshold):
            self.best = loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr


class EarlyStopper:
    """Stop when loss stops improving (reference: protgram_directgcn_trainer.py:48-65)."""

    def __init__(self, patience: int, min_delta: float):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.best_loss = float("inf")

    def should_stop(self, loss: float) -> bool:
        if loss < self.best_loss - self.min_delta:
            self.best_loss = loss
            self.counter = 0
            return False
        self.counter += 1
        return self.counter >= self.patience


def make_optimizer(params, lr: float, weight_decay: float) -> torch.optim.Adam:
    """torch.optim.Adam: L2 added to the gradient before the moments, as the
    JAX package's ``add_decayed_weights`` + ``scale_by_adam`` chain
    (trainer.py:155-159; reference: protgram_directgcn_trainer.py:354)."""
    return torch.optim.Adam(param_leaves(params), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def _loss_fn(params, graph, x, y, mask, weight_factor, gen, model_cfg, l2_lambda):
    """Masked next-node NLL plus ``l2_lambda`` times the sum of squares of
    every parameter; returns (loss, primary)."""
    log_sm, _ = directgcn_apply(params, graph, x, model_cfg, train=True, gen=gen,
                                flatten_rg=False)
    if log_sm.dim() == 3:
        # rg output: view the label/mask vectors [A, G] to match.
        y = y.reshape(log_sm.shape[:2])
        mask = mask.reshape(log_sm.shape[:2])
    per_node = -torch.gather(log_sm, -1, y[..., None])[..., 0]
    primary = torch.sum(per_node * mask) / torch.clamp(mask.sum(), min=1.0)
    l2 = sum(torch.sum(torch.square(p.float())) for p in param_leaves(params))
    return primary * weight_factor + l2_lambda * l2, primary


def make_train_step(model_cfg: DirectGCNConfig, opt: torch.optim.Optimizer, l2_lambda: float):
    """One full-batch step: loss and gradients, then the optimizer update.
    Returns (loss, primary) as computed before the update."""

    def step(params, graph, x, y, mask, weight_factor, gen):
        opt.zero_grad(set_to_none=True)
        loss, primary = _loss_fn(params, graph, x, y, mask, weight_factor, gen, model_cfg,
                                 l2_lambda)
        loss.backward()
        opt.step()
        return loss.detach(), primary.detach()

    return step


# Auto-select the gather-free hypercube format when the padded node space
# [alphabet^n] stays within this multiple of the real vocabulary.
_HYPERCUBE_MAX_RATIO = 4.0


def _launch_counts() -> Dict[str, Dict[str, int]]:
    """Launches so far of every kernel, per direction (K1/K2 and ELL)."""
    return {**hyper_kernels.launch_counts(), **ell_kernels.launch_counts()}


class HierarchicalTrainer:
    """Drives n = 1..n_max training and protein pooling
    (reference run() contract: protgram_directgcn_trainer.py:271-426)."""

    # Slack the residency plan leaves free, and the floor the banks get.
    _PLAN_SLACK = 1 << 30
    _MIN_BANK = 2 << 30
    # Budget when the device reports no memory (the CPU).
    _LEVEL_HBM = 14 << 30
    # Test hook: set to an int to pin the device budget.
    _hbm_override: Optional[int] = None

    def __init__(self, config: Optional[Config] = None, device="cuda"):
        self.config = config or Config()
        self.gcn = self.config.gcn
        self.device = resolve_device(device)
        self.id_map: Dict[str, str] = {}
        # Per level: route, losses, epochs, seconds and kernel launches.
        self.level_stats: Dict[int, dict] = {}
        self.pool_seconds = 0.0

    # ------------------------------------------------------------------

    def _initial_features(self, graph: NgramGraph, prev_vocab: Optional[np.ndarray],
                          prev_embeds: Optional[np.ndarray], seed: int) -> np.ndarray:
        """Level-1: random [N, d1]; level-n: mean of prefix/suffix (n-1)-gram
        embeddings, zeros if neither exists
        (reference: protgram_directgcn_trainer.py:312-330)."""
        n = graph.num_nodes
        if graph.n == 1 or prev_vocab is None:
            rng = np.random.default_rng(seed)
            return rng.standard_normal((n, self.gcn.one_gram_init_dim)).astype(np.float32)

        dim = prev_embeds.shape[1]
        chars = graph.vocab.view(np.uint32).reshape(n, graph.n)
        prefix = np.ascontiguousarray(chars[:, :-1]).view(f"U{graph.n - 1}").ravel()
        suffix = np.ascontiguousarray(chars[:, 1:]).view(f"U{graph.n - 1}").ravel()

        def lookup(names):
            pos = np.searchsorted(prev_vocab, names)
            pos = np.clip(pos, 0, len(prev_vocab) - 1)
            return np.where(prev_vocab[pos] == names, pos, -1)

        p_idx, s_idx = lookup(prefix), lookup(suffix)
        x = np.zeros((n, dim), dtype=np.float32)
        cnt = (p_idx >= 0).astype(np.float32) + (s_idx >= 0).astype(np.float32)
        x += np.where((p_idx >= 0)[:, None], prev_embeds[np.maximum(p_idx, 0)].astype(np.float32), 0)
        x += np.where((s_idx >= 0)[:, None], prev_embeds[np.maximum(s_idx, 0)].astype(np.float32), 0)
        x /= np.maximum(cnt, 1.0)[:, None]
        return x

    # ------------------------------------------------------------------

    def _device_memory(self) -> int:
        """Bytes one level's training may use: the device's free memory less
        1 GB (``torch.cuda.mem_get_info``)."""
        if self._hbm_override is not None:
            return int(self._hbm_override)
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            return int(free) - (1 << 30)
        return self._LEVEL_HBM

    def _residency(self, n_hyper: int, feat_dim: int, num_classes: int) -> Tuple[int, int, int]:
        """(param_bytes, opt_state_bytes, dynamic_bytes) of one tier-0
        full-batch step at ``n_hyper`` nodes: f32 per-node tables (5 gates and
        the [N, out] constant per layer) and their two Adam moments; saved
        activations (input, three paths per layer), node gradients, six
        full-width backward buffers and the [N, classes] logits with their
        log-softmax and gradient.  The JAX package's estimate
        (trainer.py:1396-1452) without the TPU's 128-lane padding."""
        out_dims = list(self.gcn.hidden_layer_dims)
        n_gates = 5 * len(out_dims) if self.gcn.use_vector_coeffs else 0
        node_elems = n_hyper * (sum(out_dims) + n_gates)
        param_b = 4 * node_elems
        opt_b = 2 * 4 * node_elems
        saves = (feat_dim + 3 * sum(out_dims)) * n_hyper * 4
        grads = sum(out_dims) * n_hyper * 4
        workspace = 6 * n_hyper * max(out_dims + [feat_dim]) * 4
        logits = 3 * n_hyper * num_classes * 4
        return param_b, opt_b, saves + grads + workspace + logits

    def _level_plan(self, graph: NgramGraph, feat_dim: int,
                    num_classes: Optional[int] = None) -> int:
        """Tier 0 of the JAX package's plan (trainer.py:1455-1595): float32
        compute, float32 node parameters, no remat, Adam.  ``num_classes``
        sizes the logits (default: one class per node, the next_node task's
        count).  Returns the device bytes left for the level's propagation
        operators.  Raises
        NotImplementedError when tier 0 does not fit the device or a knob asks
        for another tier: tiers 1-4 wait (ROADMAP Queue 1, item 6)."""
        gcn = self.gcn
        for knob, ok in (("compute_dtype", ("auto", "float32")),
                         ("node_param_dtype", ("auto", "float32")),
                         ("node_param_factored", ("auto", "off")),
                         ("remat", ("auto", False, None))):
            if getattr(gcn, knob) not in ok:
                raise NotImplementedError(
                    f"gcn.{knob}={getattr(gcn, knob)!r}: only the tier-0 plan (float32, "
                    "no remat, Adam) is ported (ROADMAP Queue 1, item 6: memory tiers 1-4)"
                )
        _, alpha = vocab_char_codes(graph.vocab)
        n_hyper = int(alpha) ** graph.n if alpha else graph.num_nodes
        n_nodes = max(n_hyper, graph.num_nodes)
        chip = self._device_memory()
        classes = graph.num_nodes if num_classes is None else num_classes
        pb, ob, db = self._residency(n_nodes, feat_dim, classes)
        if pb + ob + db + self._PLAN_SLACK + self._MIN_BANK > chip:
            raise NotImplementedError(
                f"level n={graph.n}: tier 0 needs {(pb + ob + db) / 2**30:.1f} GB for "
                f"{n_nodes} nodes, the device has {chip / 2**30:.1f} GB; memory tiers 1-4 "
                "and multi-device training are not ported yet (ROADMAP Queue 1, item 6)"
            )
        budget = max(self._MIN_BANK, chip - pb - ob - db - self._PLAN_SLACK)
        return int(budget)

    def _to_device_graph(self, graph: NgramGraph, bank_budget: int,
                         feat_dim: int = 128) -> DeviceGraph:
        """The level's propagation operators (trainer.py:1602-1633):
        "pallas" means "ell"; under "auto" and "hypercube" the hypercube is
        tried at n >= 2 ("auto": only while alpha^n <= 4x the vocabulary),
        and where it is not taken or cannot be built (auto only) the format
        is ``graph.to_device(mode="auto", feat_dim=...)``'s choice."""
        mode = self.gcn.spmm_mode if self.gcn.spmm_mode != "pallas" else "ell"
        if graph.n >= 2 and graph.num_nodes and mode in ("auto", "hypercube"):
            want = mode == "hypercube"
            if not want:
                _, alpha = vocab_char_codes(graph.vocab)
                want = 0 < alpha**graph.n <= _HYPERCUBE_MAX_RATIO * graph.num_nodes
            if want:
                try:
                    return graph.to_device(mode="hypercube", feat_dim=feat_dim,
                                           device=self.device, hbm_budget=bank_budget)
                except BlockStructureError as exc:
                    if mode == "hypercube":
                        raise
                    logger.info("hypercube format unavailable (%s); falling back", exc)
        return graph.to_device(mode="auto" if mode == "hypercube" else mode, feat_dim=feat_dim,
                               device=self.device)

    # ------------------------------------------------------------------

    def train_level(self, graph: NgramGraph, x_np: np.ndarray, y_np: np.ndarray,
                    num_classes: int) -> Tuple[dict, np.ndarray, DirectGCNConfig, DeviceGraph]:
        """Train one n-gram level full-batch; returns (params, node
        embeddings of the real nodes, model config, device graph)."""
        gcn = self.gcn
        dev = self.device
        n_val = graph.n
        feat_dim = x_np.shape[1]
        layer_dims = tuple([feat_dim] + list(gcn.hidden_layer_dims))
        budget = self._level_plan(graph, feat_dim, num_classes)
        t_ops = time.monotonic()
        full_graph = self._to_device_graph(graph, budget, feat_dim)
        operator_seconds = time.monotonic() - t_ops
        node_map = None if full_graph.node_map is None else full_graph.node_map.cpu().numpy()
        total_nodes = full_graph.num_nodes

        use_cluster = (gcn.use_cluster_training
                       and graph.num_nodes > gcn.cluster_training_threshold_nodes)
        if use_cluster and gcn.cluster_auto_fullbatch and full_graph.route == "hypercube":
            logger.info("auto-routing n=%d to full-batch (hypercube operators built)", n_val)
            use_cluster = False
        if use_cluster:
            raise NotImplementedError(
                f"level n={n_val}: cluster training ({graph.num_nodes} nodes > "
                f"{gcn.cluster_training_threshold_nodes}) is not ported yet (ROADMAP Queue 1)"
            )

        def pad_nodes(arr: np.ndarray) -> np.ndarray:
            """Scatter real-node rows into the device graph's node space."""
            if node_map is None:
                return arr
            out = np.zeros((total_nodes,) + arr.shape[1:], dtype=arr.dtype)
            out[node_map] = arr
            return out

        model_cfg = DirectGCNConfig(
            layer_dims=layer_dims,
            num_nodes=total_nodes,
            num_classes=num_classes,
            n_gram_len=n_val,
            one_gram_dim=(gcn.one_gram_init_dim if n_val == 1 else 0),
            max_pe_len=gcn.max_pe_len,
            dropout=gcn.dropout_rate,
            use_vector_coeffs=gcn.use_vector_coeffs,
            use_pallas=gcn.spmm_mode == "pallas",
        )
        init_gen = torch.Generator(device=dev).manual_seed(self.config.random_state + n_val)
        params = init_directgcn_params(init_gen, model_cfg, device=dev)
        for p in param_leaves(params):
            p.requires_grad_(True)

        l2_lambda = gcn.l2_reg_lambda
        wd = gcn.weight_decay if l2_lambda <= 0 else 0.0
        opt = make_optimizer(params, gcn.lr, wd)
        step = make_train_step(model_cfg, opt, l2_lambda)
        sched = (PlateauScheduler(gcn.lr, gcn.lr_scheduler_patience, gcn.lr_scheduler_factor)
                 if gcn.use_lr_scheduler else None)
        stopper = (EarlyStopper(gcn.early_stopping_patience, gcn.early_stopping_min_delta)
                   if gcn.use_early_stopping else None)
        drop_gen = torch.Generator(device=dev).manual_seed(
            self.config.random_state * 7919 + n_val)

        x = torch.from_numpy(pad_nodes(x_np.astype(np.float32))).to(dev)
        if full_graph.route == "hypercube":
            x = x.reshape(full_graph.p_in.feature_shape + (feat_dim,))
        y = torch.from_numpy(pad_nodes(y_np.astype(np.int64))).to(dev)
        mask = torch.from_numpy(pad_nodes(np.ones(graph.num_nodes, dtype=np.float32))).to(dev)

        launches0 = _launch_counts()
        losses = []
        t0 = time.monotonic()
        for epoch in range(1, gcn.epochs_per_level + 1):
            loss, _ = step(params, full_graph, x, y, mask, 1.0, drop_gen)
            loss_val = float(loss)
            losses.append(loss_val)
            if sched is not None:
                set_learning_rate(opt, sched.step(loss_val))
            if stopper is not None and stopper.should_stop(loss_val):
                logger.info("early stop at epoch %d (best %.5f)", epoch, stopper.best_loss)
                break
        seconds = time.monotonic() - t0
        launches1 = _launch_counts()
        logger.info("n=%d full-batch training on %s (%s): %d epochs in %.2fs (final loss %.5f)",
                    n_val, dev, full_graph.route, len(losses), seconds,
                    losses[-1] if losses else float("nan"))

        # Eval-mode embeddings on the full graph (reference: models_utils.py:264-273).
        t_eval = time.monotonic()
        with torch.no_grad():
            _, embeds = directgcn_apply(params, full_graph,
                                        torch.from_numpy(pad_nodes(x_np.astype(np.float32))).to(dev),
                                        model_cfg, train=False)
        embeds = embeds.cpu().numpy()
        if node_map is not None:
            embeds = embeds[node_map]
        eval_seconds = time.monotonic() - t_eval
        self.level_stats[n_val] = {
            "route": full_graph.route,
            "nodes": graph.num_nodes,
            "device_nodes": total_nodes,
            "epochs": len(losses),
            "losses": losses,
            "operator_seconds": operator_seconds,  # host build + copy of the operators
            "train_seconds": seconds,
            "eval_seconds": eval_seconds,  # eval pass and copy of the embeddings to the host
            "launches": {k: {d: launches1[k][d] - launches0[k][d] for d in launches1[k]}
                         for k in launches1},
        }
        return params, embeds, model_cfg, full_graph

    # ------------------------------------------------------------------

    def run(self, fasta_path: Optional[os.PathLike] = None,
            graphs_dir: Optional[os.PathLike] = None,
            output_dir: Optional[os.PathLike] = None) -> Optional[Dict[str, np.ndarray]]:
        """Train every level, cascade features, checkpoint each level's
        embeddings to ``level_{n}.npz`` (and resume from them), and return the
        final level's embeddings mean-pooled per protein."""
        cfg = self.config
        fasta_path = fasta_path or cfg.paths.input_fasta
        graphs_dir = graphs_dir or cfg.paths.graph_objects_dir
        output_dir = ensure_dir(output_dir or cfg.paths.gcn_embeddings_dir)
        ckpt_dir = ensure_dir(os.path.join(str(output_dir), "level_checkpoints"))

        if cfg.id_mapping_mode == "regex":
            self.id_map = generate_regex_id_map(fasta_path, cfg.paths.id_mapping_output_file)
            logger.info("loaded %d ID mappings", len(self.id_map))
        elif cfg.id_mapping_mode != "none":
            raise NotImplementedError(f"id_mapping_mode={cfg.id_mapping_mode!r} is not ported")

        level_embeds: Dict[int, np.ndarray] = {}
        level_vocab: Dict[int, np.ndarray] = {}
        n_max = cfg.graph_builder.ngram_max_n

        for n_val in range(1, n_max + 1):
            ckpt_path = os.path.join(str(ckpt_dir), f"level_{n_val}.npz")
            graph_path = os.path.join(str(graphs_dir), f"ngram_graph_n{n_val}.npz")
            if not os.path.exists(graph_path):
                logger.error("graph artifact missing for n=%d: %s", n_val, graph_path)
                continue
            graph = load_graph(graph_path)
            if graph.num_nodes == 0:
                logger.warning("skipping n=%d (empty graph)", n_val)
                continue
            level_vocab[n_val] = graph.vocab

            if os.path.exists(ckpt_path):
                with np.load(ckpt_path, allow_pickle=False) as z:
                    level_embeds[n_val] = z["embeddings"]
                logger.info("resumed n=%d from checkpoint (%s)", n_val, ckpt_path)
                continue

            t_level = time.monotonic()
            task = self.gcn.task_types_per_level.get(n_val, self.gcn.default_task_type)
            logger.info("=== level n=%d: %d nodes, task=%s ===", n_val, graph.num_nodes, task)
            prev_vocab = level_vocab.get(n_val - 1)
            prev_embeds = level_embeds.get(n_val - 1)
            if n_val > 1 and (prev_embeds is None or prev_embeds.size == 0):
                logger.error("previous level embeddings missing for n=%d; skipping", n_val)
                continue
            x = self._initial_features(graph, prev_vocab, prev_embeds, cfg.random_state + n_val)
            y, num_classes = generate_labels(graph, task, self.gcn.closest_aa_k_hops,
                                             cfg.random_state)
            _, embeds, _, _ = self.train_level(graph, x, y, num_classes)
            level_embeds[n_val] = embeds
            np.savez_compressed(ckpt_path, embeddings=embeds)
            # Features, labels, operators, training, eval pass and checkpoint.
            self.level_stats[n_val]["level_seconds"] = time.monotonic() - t_level

        if n_max not in level_embeds or level_embeds[n_max].size == 0:
            logger.error("final level n=%d embeddings missing; cannot pool", n_max)
            return None

        # Pool n-gram embeddings to proteins and rename ids
        # (reference: protgram_directgcn_trainer.py:387-421).
        t_pool = time.monotonic()
        sequences = list(parse_fasta(fasta_path))
        pooled = emb_utils.pool_ngram_embeddings_for_proteins(
            sequences, n_max, level_vocab[n_max], level_embeds[n_max]
        )
        if self.id_map:
            pooled = {self.id_map.get(k, k): v for k, v in pooled.items()}
        self.pool_seconds = time.monotonic() - t_pool
        logger.info("pooled n=%d embeddings for %d proteins", n_max, len(pooled))
        return pooled
