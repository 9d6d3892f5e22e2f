"""Run naming helpers (counterpart of `hipgp_tpu/utils/naming.py`; the
reference's `ziggy/misc/util.py:13-50`)."""
from __future__ import annotations

import datetime
import json

import numpy as np
import torch

__all__ = ["add_date_time", "NumpyEncoder", "print_vec"]


def add_date_time(s: str = "") -> str:
    """Append a _Dyymmdd_HHMMSS stamp to a run name."""
    return s + datetime.datetime.now().strftime("_D%y%m%d_%H%M%S")


class NumpyEncoder(json.JSONEncoder):
    """JSON encoder accepting numpy scalars and arrays, and tensors (0-dim
    ones as numbers, others as nested lists)."""

    def default(self, obj):
        if isinstance(obj, torch.Tensor):
            obj = obj.detach().cpu().numpy()
            if obj.ndim == 0:
                obj = obj[()]
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def print_vec(name, vec):
    """Print max, min and mean of |vec| (a tensor or an array)."""
    a = torch.abs(torch.as_tensor(vec))
    print(f"{name} max = {float(torch.max(a))}, min = {float(torch.min(a))}, "
          f"mean = {float(torch.mean(a))}")
