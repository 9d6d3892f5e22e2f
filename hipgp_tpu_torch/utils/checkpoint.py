"""Saving and loading model states and prediction archives.

Counterpart of `hipgp_tpu/utils/checkpoint.py`, for the model state: the
same file layout, so a state saved by either package loads in the other.  A
state is an ``.npz`` of its fields in :class:`HIPGPState` field order
(``arr_0`` ... ``arr_4``: theta1, theta2, log_sig2, log_ell, log_noise2),
beside a ``.treedef.json`` sidecar; a checkpoint directory holds
``state.npz`` and ``meta.json`` (the step).  Optimizer state and resume of a
fit are not ported yet (ROADMAP.md section A item 1).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree", "save_checkpoint", "save_predictions",
           "load_predictions"]


def _leaves(tree: Any):
    """The tensors of a state dataclass, in field order."""
    if not dataclasses.is_dataclass(tree):
        raise TypeError(f"expected a state dataclass, got {type(tree).__name__}")
    return [getattr(tree, f.name) for f in dataclasses.fields(tree)]


def _treedef(tree: Any) -> str:
    # the string the JAX package writes for its registered dataclass
    n = len(dataclasses.fields(tree))
    return f"PyTreeDef(CustomNode({type(tree).__name__}[()], [{', '.join('*' * n)}]))"


def save_pytree(path: str, tree: Any) -> None:
    """Save a state as an .npz of its fields (``arr_i`` in field order) and
    a json treedef sidecar at ``path + '.treedef.json'``."""
    leaves = _leaves(tree)
    np.savez(path, *[t.detach().cpu().numpy() for t in leaves])
    with open(path + ".treedef.json", "w") as f:
        json.dump({"treedef": _treedef(tree), "n_leaves": len(leaves)}, f)


def load_pytree(path: str, like: Any) -> Any:
    """A state saved by :func:`save_pytree` (or the JAX package's), with the
    type, dtypes and devices of ``like``."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path)
    arrays = [data[k] for k in data.files]
    like_leaves = _leaves(like)
    if len(arrays) != len(like_leaves):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, template has {len(like_leaves)}")
    fields = [f.name for f in dataclasses.fields(like)]
    return dataclasses.replace(like, **{
        name: torch.as_tensor(a).to(dtype=lk.dtype, device=lk.device)
        for name, a, lk in zip(fields, arrays, like_leaves)})


def save_checkpoint(odir: str, state: Any, opt_state: Any = None, step: int = 0,
                    extra: Optional[Dict] = None) -> None:
    """``odir/state.npz`` (with its sidecar) and ``odir/meta.json``, in the
    JAX package's signature; an ``opt_state`` (the optimizer's saved form)
    is not ported yet (ROADMAP.md section A item 1) and raises
    NotImplementedError."""
    if opt_state is not None:
        raise NotImplementedError("saving the optimizer state is not ported yet "
                                  "(ROADMAP.md section A item 1)")
    os.makedirs(odir, exist_ok=True)
    save_pytree(os.path.join(odir, "state.npz"), state)
    with open(os.path.join(odir, "meta.json"), "w") as f:
        json.dump({"step": step, **(extra or {})}, f, default=float)


def save_predictions(path: str, pdict: Dict[str, Optional[np.ndarray]]) -> None:
    """Prediction archive as .npz; None values skipped."""
    np.savez(path, **{k: np.asarray(v) for k, v in pdict.items() if v is not None})


def load_predictions(path: str) -> Dict[str, np.ndarray]:
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path)
    return {k: data[k] for k in data.files}
