"""Saving and loading model states and prediction archives.

Counterpart of `hipgp_tpu/utils/checkpoint.py`, for the model state: the
same file layout, so a state saved by either package loads in the other.  A
state is an ``.npz`` of its fields in :class:`HIPGPState` field order
(``arr_0`` ... ``arr_4``: theta1, theta2, log_sig2, log_ell, log_noise2),
beside a ``.treedef.json`` sidecar; a checkpoint directory holds
``state.npz``, ``meta.json`` (the step) and, when an optimizer is saved,
``opt_state.npz``: the leaves of the JAX package's optax state in its
flatten order (`infer.fit.FitOptimizer.leaves`), with the JAX treedef string
in its sidecar.  The JAX package's ``load_pytree`` checks only the leaf
count of either file against its template, so a checkpoint written by
either package resumes a fit in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree", "save_checkpoint", "restore_checkpoint",
           "save_predictions", "load_predictions"]


def _leaves(tree: Any):
    """The tensors of a state dataclass, in field order."""
    if not dataclasses.is_dataclass(tree):
        raise TypeError(f"expected a state dataclass, got {type(tree).__name__}")
    return [getattr(tree, f.name) for f in dataclasses.fields(tree)]


def _treedef(tree: Any) -> str:
    # the string the JAX package writes for its registered dataclass
    n = len(dataclasses.fields(tree))
    return f"PyTreeDef(CustomNode({type(tree).__name__}[()], [{', '.join('*' * n)}]))"


def _save_leaves(path: str, leaves, treedef: str) -> None:
    """An .npz of ``leaves`` (``arr_i`` in order) and its json sidecar."""
    np.savez(path, *[t.detach().cpu().numpy() for t in leaves])
    with open(path + ".treedef.json", "w") as f:
        json.dump({"treedef": treedef, "n_leaves": len(leaves)}, f)


def _load_leaves(path: str, n: int):
    """The arrays of an .npz written by :func:`_save_leaves` (or the JAX
    package's ``save_pytree``), checked to be ``n``."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        arrays = [data[k] for k in data.files]
    if len(arrays) != n:
        raise ValueError(f"checkpoint has {len(arrays)} leaves, template has {n}")
    return arrays


def save_pytree(path: str, tree: Any) -> None:
    """Save a state as an .npz of its fields (``arr_i`` in field order) and
    a json treedef sidecar at ``path + '.treedef.json'``."""
    _save_leaves(path, _leaves(tree), _treedef(tree))


def load_pytree(path: str, like: Any) -> Any:
    """A state saved by :func:`save_pytree` (or the JAX package's), with the
    type, dtypes and devices of ``like``."""
    like_leaves = _leaves(like)
    arrays = _load_leaves(path, len(like_leaves))
    fields = [f.name for f in dataclasses.fields(like)]
    return dataclasses.replace(like, **{
        name: torch.as_tensor(a).to(dtype=lk.dtype, device=lk.device)
        for name, a, lk in zip(fields, arrays, like_leaves)})


def save_checkpoint(odir: str, state: Any, opt_state: Any = None, step: int = 0,
                    extra: Optional[Dict] = None) -> None:
    """``odir/state.npz`` (with its sidecar), ``odir/meta.json`` and, for an
    ``opt_state`` (the fit's `infer.fit.FitOptimizer`), ``odir/opt_state.npz``
    with the JAX package's leaves and treedef string, in the JAX package's
    signature."""
    os.makedirs(odir, exist_ok=True)
    save_pytree(os.path.join(odir, "state.npz"), state)
    if opt_state is not None:
        _save_leaves(os.path.join(odir, "opt_state.npz"), opt_state.leaves(state),
                     opt_state.treedef(state))
    with open(os.path.join(odir, "meta.json"), "w") as f:
        json.dump({"step": step, **(extra or {})}, f, default=float)


def restore_checkpoint(odir: str, state_like: Any,
                       opt_state_like: Any = None) -> Tuple[Any, Any, int]:
    """(state, opt_state or None, step) from a directory that either package
    wrote.  The state takes the type, dtypes and devices of ``state_like``;
    with an ``opt_state_like`` (a `infer.fit.FitOptimizer` of the fit's
    configuration) and an ``opt_state.npz``, that optimizer is loaded from
    the file and returned."""
    state = load_pytree(os.path.join(odir, "state.npz"), state_like)
    opt_state = None
    opt_path = os.path.join(odir, "opt_state.npz")
    if opt_state_like is not None and os.path.exists(opt_path):
        n = len(opt_state_like.leaves(state))
        opt_state_like.load_leaves(_load_leaves(opt_path, n), state)
        opt_state = opt_state_like
    step = 0
    meta_path = os.path.join(odir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            step = int(json.load(f).get("step", 0))
    return state, opt_state, step


def save_predictions(path: str, pdict: Dict[str, Optional[np.ndarray]]) -> None:
    """Prediction archive as .npz; None values skipped."""
    np.savez(path, **{k: np.asarray(v) for k, v in pdict.items() if v is not None})


def load_predictions(path: str) -> Dict[str, np.ndarray]:
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path)
    return {k: data[k] for k in data.files}
