"""Carry parameters and operators over from the JAX package.

The functions take trees of arrays that ``np.asarray`` reads (numpy arrays,
or the JAX package's arrays, which convert without this module importing
JAX) and return torch tensors on ``device``: the card unless the caller asks
for the CPU (``utils.device.resolve_device``).  ``opt_state_from_jax``
reads the JAX package's optax states by their fields (named tuples), so it
needs no optax either.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from protgram_directgcn_torch.ops.hypercube import HypercubeAdj
from protgram_directgcn_torch.ops.spmm import BucketedEllAdj, CooAdj, EllAdj
from protgram_directgcn_torch.utils.device import resolve_device


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(tree: Any, device: Union[str, torch.device] = "cuda") -> Any:
    """``init_directgcn_params``'s pytree as the port's parameters: the same
    nested dicts and lists, by the names of directgcn.py:114-180 (``w_*``,
    ``b_*``, the gates ``c_in``/``c_out``/``c_directed``/``c_undirected``/
    ``c_all``, ``constant``, ``res_projs``, ``decoder``, ``pe_table``).
    Each leaf keeps its shape and type: a constant stored rg ``[A, G, out]``
    (both trainers' hypercube levels) stays rg, and bf16 node tables come
    across bit for bit."""
    return _params(tree, resolve_device(device))


def _params(tree: Any, device: torch.device) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_params(v, device) for v in tree]
    return _tensor(tree, device)


def mlp_params_from_jax(params: Any, device: Union[str, torch.device] = "cuda") -> dict:
    """``models/mlp.py``'s ``init_mlp_params`` dict (``w1, b1, w2, b2, w3,
    b3``) as float32 tensors for ``MLPTrainer.set_params``."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev).float() for k, v in params.items()}


def skipgram_params_from_jax(params: Any, device: Union[str, torch.device] = "cuda") -> dict:
    """``SkipGramModel.params`` of the JAX package (``"in"``, ``"out"``,
    each ``[V, D]``) as float32 tensors, the port model's ``params``."""
    dev = resolve_device(device)
    return {k: _tensor(params[k], dev).float() for k in ("in", "out")}


def params_to_numpy(tree: Any) -> Any:
    """The port's parameters as a tree of float32 numpy arrays (for handing
    them to the JAX package)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().float().cpu().numpy()


def hyper_from_jax(adj: Any, device: Union[str, torch.device] = "cuda",
                   dtype: Optional[torch.dtype] = None) -> HypercubeAdj:
    """A JAX ``HypercubeAdj`` in any bank layout (hypercube.py:67-99) as the
    port's r-major banks ``[A, G, A]``:

    - "dual"/"rs": ``wf_rs``/``wb_rs`` are already r-major (the g-major copies
      are dropped);
    - "pk": ``[A*A, G]`` with row ``r*A + c`` is reshaped ``[A, A, G]`` and
      permuted to ``[r, g, c]``.
    """
    device = resolve_device(device)
    d = np.asarray(adj.d, np.float32)
    a, g = d.shape
    banks = []
    for w in (adj.wf_rs, adj.wb_rs):
        t = _tensor(w, "cpu")
        if t.dim() == 2:  # packed [A*A, G]
            t = t.reshape(a, a, g).permute(0, 2, 1)
        banks.append(t.contiguous().to(device=device, dtype=dtype or t.dtype))
    return HypercubeAdj(
        d=torch.from_numpy(d.copy()).to(device),
        wf_rs=banks[0],
        wb_rs=banks[1],
        node_map=torch.from_numpy(np.asarray(adj.node_map).astype(np.int64)).to(device),
    )


def ell_from_jax(adj: Any, device: Union[str, torch.device] = "cuda"
                 ) -> Union[EllAdj, BucketedEllAdj, CooAdj]:
    """A JAX ``EllAdj``, ``BucketedEllAdj`` or ``CooAdj`` (spmm.py:100-153)
    as the port's, array for array (told apart by their fields: ``inv_perm``
    for bucketed, ``src`` for COO)."""
    device = resolve_device(device)
    if hasattr(adj, "inv_perm"):
        return BucketedEllAdj(
            idx=tuple(_tensor(a, device) for a in adj.idx),
            w=tuple(_tensor(a, device) for a in adj.w),
            inv_perm=_tensor(adj.inv_perm, device),
            idx_t=tuple(_tensor(a, device) for a in adj.idx_t),
            w_t=tuple(_tensor(a, device) for a in adj.w_t),
            inv_perm_t=_tensor(adj.inv_perm_t, device),
        )
    if hasattr(adj, "src"):
        return CooAdj(**{k: _tensor(getattr(adj, k), device)
                         for k in ("src", "tgt", "w", "src_t", "tgt_t", "w_t")},
                      n_out=int(adj.n_out), n_in=int(adj.n_in))
    return EllAdj(**{k: _tensor(getattr(adj, k), device) for k in ("idx", "w", "idx_t", "w_t")})


def _leaf_pairs(jtree: Any, ptree: Any):
    """(JAX leaf, port tensor) of two trees of the same layout, skipping the
    leaves an optax mask left out (``MaskedNode``) and None subtrees."""
    if ptree is None or type(jtree).__name__ == "MaskedNode":
        return
    if isinstance(ptree, dict):
        for k in ptree:
            yield from _leaf_pairs(jtree[k], ptree[k])
    elif isinstance(ptree, (list, tuple)):
        for jv, pv in zip(jtree, ptree):
            yield from _leaf_pairs(jv, pv)
    else:
        yield jtree, ptree


def _named_tuples(obj: Any):
    """Every named tuple inside an optax state (depth first)."""
    if hasattr(obj, "_fields"):
        yield obj
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _named_tuples(v)


def _carry_state(state: Any, params: Any, opt: torch.optim.Optimizer) -> None:
    for st in _named_tuples(state):
        fields = tuple(st._fields)
        if "hyperparams" in fields:
            for group in opt.param_groups:
                group["lr"] = float(np.asarray(st.hyperparams["learning_rate"]))
        elif fields == ("count", "mu", "nu"):  # optax ScaleByAdamState
            step = int(np.asarray(st.count))
            for (mu, p), (nu, _) in zip(_leaf_pairs(st.mu, params), _leaf_pairs(st.nu, params)):
                opt.state[p] = {"step": step, "mu": _tensor(mu, p.device).float(),
                                "nu": _tensor(nu, p.device).float()}
        elif fields == ("count", "v_row", "v_col", "v"):  # optax FactoredState
            step = int(np.asarray(st.count))
            for (vr, p), (vc, _), (v, _) in zip(_leaf_pairs(st.v_row, params),
                                                _leaf_pairs(st.v_col, params),
                                                _leaf_pairs(st.v, params)):
                full = np.asarray(v).shape == tuple(p.shape)
                opt.state[p] = {"step": step, **(
                    {"v": _tensor(v, p.device).float()} if full else
                    {"v_row": _tensor(vr, p.device).float(),
                     "v_col": _tensor(vc, p.device).float()})}


def opt_state_from_jax(state: Any, params: Any, opt: torch.optim.Optimizer) -> None:
    """Carry the JAX package's optimizer state into ``opt`` (a
    ``TrainOptimizer`` over ``params``), in place: each leaf's Adam moments
    or Adafactor moments (full, or factored row and column) in float32 with
    the step count, and the learning rate of ``inject_hyperparams``.  A
    staged step's ``StagedOptState`` holds one state per stage over that
    stage's sub-tree, a stage per layer and the decoder's last, as the JAX
    trainer builds it (trainer.py:1952-1958, 337-342); each is carried onto
    the same leaves of ``params``."""
    stages = getattr(state, "stages", None)
    if stages is None:
        _carry_state(state, params, opt)
        return
    n_layers = len(params["layers"])
    bounds = list(range(n_layers + 1)) + [n_layers]
    for k, st in enumerate(stages):
        lo, hi = bounds[k], bounds[k + 1]
        sub = {"layers": params["layers"][lo:hi], "res_projs": params["res_projs"][lo:hi]}
        if k == len(stages) - 1:
            sub["decoder"] = params["decoder"]
        _carry_state(st, sub, opt)
