"""Prediction-quality metrics without pandas: the RMSE and the mean
log-likelihood of `hipgp_tpu/utils/metrics.error_frame`'s 'f mse' and
'f loglike' columns."""
from __future__ import annotations

import math

import numpy as np

__all__ = ["rmse", "mean_loglike", "error_summary"]

_LN2PI = math.log(2.0 * math.pi)


def rmse(truth, mu) -> float:
    """Root mean squared error, NaN entries ignored."""
    resid = np.asarray(truth, np.float64).reshape(-1) - np.asarray(mu, np.float64).reshape(-1)
    return float(np.sqrt(np.nanmean(resid ** 2)))


def mean_loglike(truth, mu, sig) -> float:
    """Mean Gaussian log-likelihood of the truth under N(mu, sig^2)."""
    truth = np.asarray(truth, np.float64).reshape(-1)
    mu = np.asarray(mu, np.float64).reshape(-1)
    sig = np.asarray(sig, np.float64).reshape(-1)
    ll = -0.5 * _LN2PI - np.log(sig) - 0.5 * ((truth - mu) / sig) ** 2
    return float(np.nanmean(ll))


def error_summary(truth, mu, sig) -> dict:
    """{'rmse', 'mae', 'loglike'} of one set of predictions."""
    resid = np.asarray(truth, np.float64).reshape(-1) - np.asarray(mu, np.float64).reshape(-1)
    return {"rmse": rmse(truth, mu), "mae": float(np.nanmean(np.abs(resid))),
            "loglike": mean_loglike(truth, mu, sig)}
