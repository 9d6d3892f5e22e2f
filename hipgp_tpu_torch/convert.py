"""Carry a model state between the JAX package and this one as numpy arrays.

A JAX ``HIPGPState`` becomes ``{"theta1", "theta2", "log_sig2", "log_ell",
"log_noise2"}`` numpy arrays on the JAX side (``np.asarray`` of each field),
a JAX ``SVGPState`` the same without ``log_noise2``;
:func:`state_from_numpy` turns such a dict into the class the caller names,
:class:`~hipgp_tpu_torch.models.HIPGPState` (the default) or
:class:`~hipgp_tpu_torch.models.SVGPState`, and :func:`state_to_numpy` goes
back.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Type, Union

import numpy as np
import torch

from .models.hipgp import HIPGPState
from .models.svgp import SVGPState

__all__ = ["state_from_numpy", "state_to_numpy", "STATE_FIELDS"]

STATE_FIELDS = tuple(f.name for f in dataclasses.fields(HIPGPState))


def state_from_numpy(d: Dict[str, np.ndarray], dtype: torch.dtype = None,
                     device="cuda", cls: Type = HIPGPState
                     ) -> Union[HIPGPState, SVGPState]:
    """A ``cls`` state (HIPGPState or SVGPState) from a dict of numpy
    arrays, in ``dtype`` (default: the arrays' own) on ``device``; KeyError
    when the dict lacks one of its fields."""
    missing = [f.name for f in dataclasses.fields(cls) if f.name not in d]
    if missing:
        raise KeyError(f"state dict lacks {missing}")
    return cls(**{f.name: torch.as_tensor(np.array(d[f.name])).to(device=device, dtype=dtype)
                  for f in dataclasses.fields(cls)})


def state_to_numpy(state: Union[HIPGPState, SVGPState]) -> Dict[str, np.ndarray]:
    """The state as a dict of numpy arrays (copied to the host)."""
    return {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(state)}
