"""Paper section 5.4: UK housing, log flat prices over lat/lon, on the port.

Counterpart of `hipgp_tpu/experiments/run_ukhousing.py`, with the same CLI:
2018 flat transactions, mean-centred log price over (longitude, latitude)
in the region (-5.7, 1.8) x (50, 55.5), per-point noise std from local
linear fits in random boxes, fit through the harness (the 'dense' closed
form by default).  ``--data-path`` reads a prepared CSV with columns
longitude, latitude, log_price (`prepare_uk_housing_csv` builds it from the
raw land-registry prices and a postcode table); without it a synthetic price
surface over the same region stands in.  The CSVs are read and written with
the ``csv`` module (no pandas).  ``--device`` (default cuda) and ``--f64``
are the port's.  ``--parallel dp`` fits data-parallel, one process per
device: ``torchrun --nproc-per-node N -m
hipgp_tpu_torch.experiments.run_ukhousing --parallel dp`` (without torchrun,
a world of one process); ``--parallel mp`` fits model-parallel the same way,
the whitened state split over a (1, world) ('dp', 'grid') mesh (mean-field
and block; the harness's 'dense' becomes the split 'cg').

Usage: python -m hipgp_tpu_torch.experiments.run_ukhousing
       (add --device cpu --nobs 400 --ntest 80 --num-inducing-x 10
       --num-inducing-y 8 for a small CPU run)
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from ..infer import FitConfig
from .harness import fit_predict_and_save, init_parallel

__all__ = ["main", "ROI", "prepare_uk_housing_csv", "load_prepared_csv",
           "local_noise_estimate", "synthetic_housing_data"]

ROI = (-5.7, 1.8, 50.0, 55.5)  # lon_lo, lon_hi, lat_lo, lat_hi


def _number(s: str) -> float:
    try:
        return float(s)
    except ValueError:
        return float("nan")


def prepare_uk_housing_csv(price_csv: str, postcode_csv: str, out_csv: str):
    """Join raw land-registry prices with a postcode -> lat/lon table, as
    the reference's raw pipeline does: price in column 1, postcode column
    3, property type column 4 ('F', flats, kept); a left join on the
    postcode, in the price file's order; rows without a longitude, with a
    price below 1000 or a latitude above 65 dropped.  ``postcode_csv`` has a
    header row with postcode, latitude and longitude columns (any case).
    Writes longitude, latitude, log_price; returns ``out_csv``."""
    with open(postcode_csv, newline="") as f:
        rows = csv.reader(f)
        header = [c.lower() for c in next(rows)]
        ipc, ilat, ilon = (header.index(c) for c in ("postcode", "latitude", "longitude"))
        where = {}
        for r in rows:
            where.setdefault(r[ipc], []).append((_number(r[ilat]), _number(r[ilon])))
    out = []
    with open(price_csv, newline="") as f:
        for r in csv.reader(f):
            if r[4] != "F":
                continue
            price = float(r[1])
            for lat, lon in where.get(r[3], [(float("nan"), float("nan"))]):
                if np.isnan(lon) or price < 1000 or lat > 65:
                    continue
                out.append((lon, lat, float(np.log(price))))
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["longitude", "latitude", "log_price"])
        w.writerows(out)
    return out_csv


def load_prepared_csv(path: str):
    """The region filter and the mean-centring of a prepared CSV: (x (N, 2)
    longitude/latitude, y (N,) mean-centred log price)."""
    with open(path, newline="") as f:
        rows = csv.reader(f)
        header = next(rows)
        cols = [header.index(c) for c in ("longitude", "latitude", "log_price")]
        data = np.asarray([[float(r[c]) for c in cols] for r in rows], dtype=np.float64)
    x, y = data[:, :2], data[:, 2]
    m = ((x[:, 0] > ROI[0]) & (x[:, 0] < ROI[1])
         & (x[:, 1] > ROI[2]) & (x[:, 1] < ROI[3]))
    x, y = x[m], y[m]
    return x, y - y.mean()


def local_noise_estimate(x, y, num_boxes: int = 500, box_frac: float = 0.02,
                         seed: int = 0):
    """Per-point noise std from the residuals of local linear fits in
    random boxes; points no box covers get the median."""
    rs = np.random.RandomState(seed)
    lo, hi = x.min(axis=0), x.max(axis=0)
    span = (hi - lo) * box_frac
    sig = np.full(len(x), np.nan)
    for _ in range(num_boxes):
        c = rs.uniform(lo, hi)
        mask = np.all(np.abs(x - c) < span, axis=1)
        if mask.sum() < 10:
            continue
        xb = np.column_stack([x[mask], np.ones(mask.sum())])
        coef, *_ = np.linalg.lstsq(xb, y[mask], rcond=None)
        sig[mask] = np.std(y[mask] - xb @ coef)
    med = np.nanmedian(sig) if np.isfinite(sig).any() else np.std(y)
    sig[~np.isfinite(sig)] = med
    return np.maximum(sig, 1e-3)


def synthetic_housing_data(n: int, seed: int = 0):
    rs = np.random.RandomState(seed)
    lon = rs.uniform(ROI[0], ROI[1], n)
    lat = rs.uniform(ROI[2], ROI[3], n)
    x = np.column_stack([lon, lat])
    # a smooth log-price surface: city bumps and a gradient
    centers = np.array([[-0.1, 51.5], [-2.2, 53.5], [-1.9, 52.5], [-3.2, 55.9]])
    f = 0.05 * (lat - 52)
    for c in centers:
        f = f + 0.8 * np.exp(-0.5 * np.sum((x - c) ** 2, axis=1) / 0.3 ** 2)
    y = f + 0.3 * rs.standard_normal(n)
    return x, y, f


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-path", default=None, help="CSV with longitude, latitude, log_price")
    p.add_argument("--nobs", type=int, default=20_000, help="synthetic N when no data file")
    p.add_argument("--ntest", type=int, default=2000)
    p.add_argument("--num-inducing-x", type=int, default=64)
    p.add_argument("--num-inducing-y", type=int, default=48)
    p.add_argument("--model-class", default="mean-field")
    p.add_argument("--kernel", default="Mat52")
    p.add_argument("--ell", type=float, default=0.1)
    p.add_argument("--sig2-init", type=float, default=-1.0,
                   help="marginal-variance init; <= 0 uses the empirical "
                        "distance-slope regression (the reference's default)")
    p.add_argument("--fit-method", default="full-batch", choices=["natgrad", "full-batch"])
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--maxiter-cg", type=int, default=20)
    p.add_argument("--mean-solver", default="dense",
                   choices=["dense", "cg", "gram", "factored", "matfree"])
    p.add_argument("--parallel", default=None, choices=["dp", "mp"],
                   help="over the ranks of torchrun's world: dp data-parallel, mp "
                        "model-parallel (the state split over a (1, world) grid)")
    p.add_argument("--output-dir", default="./output-ukhousing")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--f64", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    mesh, _ = init_parallel(args.parallel, args.device)

    if args.data_path and os.path.exists(args.data_path):
        x, y = load_prepared_csv(args.data_path)
        fte = None
    else:
        print("no --data-path: generating synthetic UK-housing-like data", flush=True)
        x, y, ftrue = synthetic_housing_data(args.nobs + args.ntest, args.seed)
        y = y - y.mean()
        fte = ftrue - ftrue.mean()

    perm = np.random.RandomState(args.seed).permutation(len(x))
    x, y = x[perm], y[perm]
    if fte is not None:
        fte = fte[perm]
    sobs = local_noise_estimate(x, y)
    ntr = len(x) - args.ntest
    xtest, ytest = x[ntr:], y[ntr:]
    grids = [np.linspace(ROI[0], ROI[1], args.num_inducing_x),
             np.linspace(ROI[2], ROI[3], args.num_inducing_y)]
    cfg = FitConfig(epochs=args.epochs, batch_size=args.batch_size,
                    maxiter_cg=args.maxiter_cg)
    return fit_predict_and_save(
        name=f"ukhousing-{args.model_class}",
        xobs=x[:ntr], yobs=y[:ntr], sobs=sobs[:ntr], xinduce_grids=grids,
        model_class=args.model_class, kernel=args.kernel,
        sig2_init=(args.sig2_init if args.sig2_init > 0 else "empirical"),
        ell_init=args.ell, fit_method=args.fit_method, fit_config=cfg,
        maxiter_cg=args.maxiter_cg, mean_solver=args.mean_solver,
        parallel=args.parallel, mesh=mesh, batch_solve_bsz=args.batch_size,
        xtest=xtest, ftest=fte[ntr:] if fte is not None else ytest,
        output_dir=args.output_dir,
        dtype=torch.float64 if args.f64 else torch.float32, device=args.device)


if __name__ == "__main__":
    main()
