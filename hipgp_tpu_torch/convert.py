"""Carry a HIP-GP state between the JAX package and this one as numpy arrays.

A JAX ``HIPGPState`` becomes ``{"theta1", "theta2", "log_sig2", "log_ell",
"log_noise2"}`` numpy arrays on the JAX side (``np.asarray`` of each field);
:func:`state_from_numpy` turns that dict into this package's
:class:`~hipgp_tpu_torch.models.HIPGPState`, and :func:`state_to_numpy`
goes back.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .models.hipgp import HIPGPState

__all__ = ["state_from_numpy", "state_to_numpy", "STATE_FIELDS"]

STATE_FIELDS = tuple(f.name for f in dataclasses.fields(HIPGPState))


def state_from_numpy(d: Dict[str, np.ndarray], dtype: torch.dtype = None,
                     device="cuda") -> HIPGPState:
    """A state from a dict of numpy arrays, in ``dtype`` (default: the
    arrays' own) on ``device``."""
    missing = [k for k in STATE_FIELDS if k not in d]
    if missing:
        raise KeyError(f"state dict lacks {missing}")
    return HIPGPState(**{
        k: torch.as_tensor(np.array(d[k])).to(device=device, dtype=dtype)
        for k in STATE_FIELDS
    })


def state_to_numpy(state: HIPGPState) -> Dict[str, np.ndarray]:
    """The state as a dict of numpy arrays (copied to the host)."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in STATE_FIELDS}
