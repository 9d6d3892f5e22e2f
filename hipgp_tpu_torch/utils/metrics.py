"""Prediction-quality metrics without pandas.

The RMSE and the mean log-likelihood of `hipgp_tpu/utils/metrics.error_frame`'s
'f mse' and 'f loglike' columns, the Pearson correlation of a predicted map
with the truth (the dust map's slice correlation), and the JAX module's
frames (`error_frame`, `noise_comparison_frame`, `coverage_table`, `qq_data`,
`zscore_histogram_data`) as plain dicts of columns, written by `write_csv`
with the same headers and row labels as the JAX package's ``to_csv``.
"""
from __future__ import annotations

import csv
import math
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["rmse", "mean_loglike", "error_summary", "correlation", "error_frame",
           "describe", "noise_comparison_frame", "coverage_table", "qq_data",
           "zscore_histogram_data", "write_csv"]

_LN2PI = math.log(2.0 * math.pi)


def _norm_logpdf(y, loc, scale):
    return -0.5 * _LN2PI - np.log(scale) - 0.5 * ((y - loc) / scale) ** 2


def rmse(truth, mu) -> float:
    """Root mean squared error, NaN entries ignored."""
    resid = np.asarray(truth, np.float64).reshape(-1) - np.asarray(mu, np.float64).reshape(-1)
    return float(np.sqrt(np.nanmean(resid ** 2)))


def mean_loglike(truth, mu, sig) -> float:
    """Mean Gaussian log-likelihood of the truth under N(mu, sig^2)."""
    truth = np.asarray(truth, np.float64).reshape(-1)
    mu = np.asarray(mu, np.float64).reshape(-1)
    sig = np.asarray(sig, np.float64).reshape(-1)
    return float(np.nanmean(_norm_logpdf(truth, mu, sig)))


def error_summary(truth, mu, sig) -> dict:
    """{'rmse', 'mae', 'loglike'} of one set of predictions."""
    resid = np.asarray(truth, np.float64).reshape(-1) - np.asarray(mu, np.float64).reshape(-1)
    return {"rmse": rmse(truth, mu), "mae": float(np.nanmean(np.abs(resid))),
            "loglike": mean_loglike(truth, mu, sig)}


def correlation(truth, mu) -> float:
    """Pearson correlation of the predictions with the truth."""
    t = np.asarray(truth, np.float64).reshape(-1)
    m = np.asarray(mu, np.float64).reshape(-1)
    return float(np.corrcoef(t, m)[0, 1])


# ---------------------------------------------------------------------------
# the JAX package's metric frames, as plain dicts of columns
# ---------------------------------------------------------------------------
#
# A frame is a dict {column name: list or 1-D array}, in column order; where
# the JAX frame has a row index, the dict's first key holds it, under the
# index's name ('' when unnamed), so `write_csv` writes the header and rows
# that pandas' ``to_csv`` writes for the JAX frame.


def error_frame(predictions: Dict[str, Dict[str, np.ndarray]],
                data_type: str = "test") -> Dict[str, np.ndarray]:
    """Per-point error statistics for one or more models
    ({model name: prediction dict}): the truth/mu/sig columns
    e{t}, emu_{t}, esig_{t}, f{t}, fmu_{t}, fsig_{t} (NaN where absent),
    'model', then per target e and f: 'mse', 'mae', 'loglike', 'zscore',
    'chisq' (the JAX `error_frame`'s columns, in its order)."""
    subs = [f"e{data_type}", f"emu_{data_type}", f"esig_{data_type}",
            f"f{data_type}", f"fmu_{data_type}", f"fsig_{data_type}"]
    cols = {sub: [] for sub in subs}
    cols["model"] = []
    for name, pdict in predictions.items():
        n = None
        got = {}
        for sub in subs:
            v = pdict.get(sub)
            if v is not None:
                v = np.asarray(v, np.float64).reshape(-1)
                n = len(v)
            got[sub] = v
        if n is None:
            raise ValueError(f"model {name!r} has no {data_type} predictions")
        for sub in subs:
            cols[sub].append(np.full(n, np.nan) if got[sub] is None else got[sub])
        cols["model"].append(np.full(n, name, dtype=object))
    df = {k: np.concatenate(v) for k, v in cols.items()}
    for t in ("e", "f"):
        truth, mu, sig = (df[f"{t}{data_type}"], df[f"{t}mu_{data_type}"],
                          df[f"{t}sig_{data_type}"])
        with np.errstate(invalid="ignore", divide="ignore"):
            df[f"{t} mse"] = (truth - mu) ** 2
            df[f"{t} mae"] = np.abs(truth - mu)
            df[f"{t} loglike"] = _norm_logpdf(truth, mu, sig)
            df[f"{t} zscore"] = (truth - mu) / sig
            df[f"{t} chisq"] = df[f"{t} zscore"] ** 2
    return df


DESCRIBE_ROWS = ("count", "mean", "std", "min", "25%", "50%", "75%", "max")


def describe(frame: Dict[str, np.ndarray]) -> Dict[str, list]:
    """pandas' ``describe()`` of a frame's numeric columns (count, mean,
    std with ddof 1, min, quartiles by linear interpolation, max; NaN
    entries ignored), as a frame indexed by the statistic."""
    out = {"": list(DESCRIBE_ROWS)}
    for name, col in frame.items():
        col = np.asarray(col)
        if col.dtype == object:
            continue
        v = col[~np.isnan(col)]
        if len(v) == 0:
            out[name] = [0.0] + [np.nan] * 7
            continue
        std = float(np.std(v, ddof=1)) if len(v) > 1 else np.nan
        q = np.percentile(v, [25, 50, 75])
        out[name] = [float(len(v)), float(np.mean(v)), std, float(np.min(v)),
                     *map(float, q), float(np.max(v))]
    return out


def noise_comparison_frame(pdict: Dict[str, np.ndarray], data_noise_std: float,
                           integrated_obs: bool = False,
                           train_elbo: Optional[float] = None,
                           eval_valid: bool = False) -> Dict[str, list]:
    """Post-fit RMSE against the raw observation noise: rows post-rmse,
    post-mae, data-noise, noise-reduction (%), rmse-to-std, loglike
    (+ train_elbo, + the valid variants); columns fobs (and eobs with
    integrated observations)."""
    df = error_frame({"m": pdict}, data_type="test")

    def summary(t, dt="test", frame=None):
        frame = df if frame is None else frame
        resid = frame[f"{t}{dt}"] - frame[f"{t}mu_{dt}"]
        post_rmse = float(np.sqrt(np.nanmean(resid ** 2)))
        return {
            "post-rmse": post_rmse,
            "post-mae": float(np.nanmean(np.abs(resid))),
            "data-noise": data_noise_std,
            "noise-reduction": 100.0 * (data_noise_std - post_rmse) / data_noise_std,
            "rmse-to-std": post_rmse / data_noise_std,
            "loglike": float(np.nanmean(frame[f"{t} loglike"])),
        }

    fdict = summary("f")
    if train_elbo is not None:
        fdict["train_elbo"] = float(train_elbo)
    if eval_valid:
        v = summary("f", "valid", error_frame({"m": pdict}, data_type="valid"))
        fdict["post-rmse-valid"] = v["post-rmse"]
        fdict["post-mae-valid"] = v["post-mae"]
        fdict["loglike-valid"] = v["loglike"]
    if not integrated_obs:
        return {"": list(fdict), "fobs": list(fdict.values())}
    edict = summary("e")
    if train_elbo is not None:
        edict["train_elbo"] = float(train_elbo)
    # pandas aligns two Series on the sorted union of their labels
    rows = list(fdict) if list(fdict) == list(edict) else sorted(set(fdict) | set(edict))
    return {"": rows, "fobs": [fdict.get(r, np.nan) for r in rows],
            "eobs": [edict.get(r, np.nan) for r in rows]}


def coverage_table(zscores: Dict[str, np.ndarray],
                   sigs: Sequence[float] = (0.5, 1.0, 2.0, 3.0)) -> Dict[str, list]:
    """Fraction of |z| < s per model against the standard normal's
    P(|Z| < s), indexed by 'sigma'."""
    table = {"sigma": [float(s) for s in sigs]}
    for name, z in zscores.items():
        z = np.asarray(z, np.float64)
        with np.errstate(invalid="ignore"):
            table[name] = [float(np.nanmean(np.abs(z) < s)) for s in sigs]
    table["N(0,1)"] = [math.erf(s / math.sqrt(2.0)) for s in sigs]
    return table


def qq_data(zscores: np.ndarray):
    """(theoretical quantiles, sorted z-scores) for a normal QQ plot."""
    from scipy.stats import norm

    z = np.asarray(zscores).reshape(-1)
    z = z[~np.isnan(z)]
    pgrid = np.arange(1, len(z) + 1) / (len(z) + 1)
    return norm.ppf(pgrid), np.sort(z)


def zscore_histogram_data(zscores: np.ndarray, bins: int = 30):
    """(histogram density, bin edges) of the non-NaN z-scores."""
    z = np.asarray(zscores).reshape(-1)
    z = z[~np.isnan(z)]
    return np.histogram(z, bins=bins, density=True)


def _cell(v):
    if isinstance(v, str):
        return v
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    v = float(v)
    return "" if math.isnan(v) else repr(v)


def write_csv(path: str, frame: Dict[str, Sequence]) -> None:
    """Write a frame with the `csv` module: its keys as the header, NaN as
    an empty cell, floats at full precision (pandas' ``to_csv`` layout)."""
    cols = list(frame.values())
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(list(frame))
        for i in range(len(cols[0]) if cols else 0):
            wr.writerow([_cell(c[i]) for c in cols])
