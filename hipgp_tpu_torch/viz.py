"""Plotting helpers (matplotlib, Agg backend).

Counterpart of `hipgp_tpu/viz.py`: the reference's `plot_smooth`,
`plot_comparison` and `ax_scatter`, and the harness's figures (ELBO trace,
posterior maps, z-score histogram, QQ, the dust map's scatters, the error
boxplots).  matplotlib is imported inside each function, with the Agg
backend selected there, so importing this module needs no matplotlib (the
card's machine has none); `plot_error_boxes` takes a mapping from column
to array where the JAX function takes a DataFrame, since the card has no
pandas either.
"""
from __future__ import annotations

import os
from typing import Mapping, Sequence

import numpy as np

__all__ = ["plot_smooth", "plot_comparison", "ax_scatter", "plot_elbo_trace",
           "plot_posterior_grid", "plot_qq", "plot_zscore_histogram",
           "plot_domain_result", "plot_error_boxes", "matplotlib_available"]


def _plt():
    """matplotlib.pyplot on the Agg backend (ImportError without matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, path):
    if path:
        fig.savefig(path, bbox_inches="tight")
        _plt().close(fig)
    return fig


def plot_smooth(ax, vals, xlo, xhi, ylo, yhi, vmin=None, vmax=None, cmap="viridis"):
    """imshow a gridded field with its physical extent."""
    return ax.imshow(np.asarray(vals).T, origin="lower", extent=(xlo, xhi, ylo, yhi),
                     vmin=vmin, vmax=vmax, cmap=cmap, aspect="auto")


def ax_scatter(ax, x, c=None, s=3, **kwargs):
    x = np.asarray(x)
    return ax.scatter(x[:, 0], x[:, 1], c=c, s=s, **kwargs)


def plot_comparison(ftrue_grid, fmu_grid, extent, path=None,
                    titles=("truth", "posterior mean", "error")):
    """Side-by-side truth, posterior mean and error maps."""
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    vmin, vmax = float(np.nanmin(ftrue_grid)), float(np.nanmax(ftrue_grid))
    ims = [
        plot_smooth(axes[0], ftrue_grid, *extent, vmin=vmin, vmax=vmax),
        plot_smooth(axes[1], fmu_grid, *extent, vmin=vmin, vmax=vmax),
        plot_smooth(axes[2], np.asarray(fmu_grid) - np.asarray(ftrue_grid), *extent,
                    cmap="RdBu"),
    ]
    for ax, im, t in zip(axes, ims, titles):
        ax.set_title(t)
        fig.colorbar(im, ax=ax)
    return _save(fig, path)


def plot_elbo_trace(trace, path=None):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(np.asarray(trace))
    ax.set_xlabel("batch")
    ax.set_ylabel("ELBO")
    return _save(fig, path)


def plot_posterior_grid(fmu, fsig, grid_shape, extent, path=None):
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    im0 = plot_smooth(axes[0], np.asarray(fmu).reshape(grid_shape), *extent)
    im1 = plot_smooth(axes[1], np.asarray(fsig).reshape(grid_shape), *extent, cmap="magma")
    axes[0].set_title("posterior mean")
    axes[1].set_title("posterior std")
    fig.colorbar(im0, ax=axes[0])
    fig.colorbar(im1, ax=axes[1])
    return _save(fig, path)


def plot_qq(zscores_by_model, path=None):
    from .utils.metrics import qq_data

    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot([-3, 3], [-3, 3], "--", c="grey", lw=2, zorder=-1)
    markers = ["o", "s", "d", "^", "3", "4", "8"]
    for (name, z), m in zip(zscores_by_model.items(), markers):
        znorm, zsorted = qq_data(z)
        ax.scatter(znorm[::5], zsorted[::5], s=25, label=name, marker=m)
    ax.legend(fontsize=12, frameon=True, framealpha=0.8)
    ax.set_xlim(-3.2, 3.2)
    ax.set_ylim(-3.2, 3.2)
    return _save(fig, path)


def plot_zscore_histogram(zscores, name="model", path=None):
    from scipy.stats import norm

    plt = _plt()
    z = np.asarray(zscores).reshape(-1)
    z = z[~np.isnan(z)]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(z, bins=30, density=True, alpha=0.5, label=name)
    xgrid = np.linspace(-3, 3, 100)
    ax.plot(xgrid, norm.pdf(xgrid), label="N(0,1)")
    ax.set_xlabel("z score")
    ax.set_ylabel("density")
    ax.legend(frameon=True, loc="upper left")
    ax.set_xlim(-3, 3)
    return _save(fig, path)


def plot_domain_result(odir, pdict, slice_center=0.0, slice_halfwidth=0.05):
    """The dust map's figures: for each of the posterior mean, posterior
    std, residual, relative error and z-score of the integrated observable
    e, a 3-D scatter over the test points (predict-<q>-test-3D.pdf) and a
    2-D scatter of the slice |z - slice_center| <= slice_halfwidth
    (predict-<q>-test-2D.pdf).  pdict: xtest (N, 3), etest, emu_test,
    esig_test (N,).  Returns the paths written (none when a key lacks)."""
    xtest = np.asarray(pdict["xtest"])
    if xtest.ndim != 2 or xtest.shape[1] != 3:
        return []
    if not all(pdict.get(k) is not None for k in ("etest", "emu_test", "esig_test")):
        return []
    plt = _plt()
    etest = np.asarray(pdict["etest"]).reshape(-1)
    emu = np.asarray(pdict["emu_test"]).reshape(-1)
    esig = np.asarray(pdict["esig_test"]).reshape(-1)
    eres = emu - etest
    with np.errstate(divide="ignore", invalid="ignore"):
        erel = eres / etest
        ez = -eres / esig
    quantities = [("emu", emu, "Posterior mean of $e$"),
                  ("esig", esig, "Posterior error in $e$"),
                  ("eres", eres, "Residual of $e$"),
                  ("erel", erel, "Relative error in $e$"),
                  ("ez", ez, "Z-score of $e$")]
    in_slice = np.abs(xtest[:, 2] - slice_center) <= slice_halfwidth
    written = []
    for tag, vals, label in quantities:
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")
        im = ax.scatter(xtest[:, 0], xtest[:, 1], xtest[:, 2], c=vals, s=20)
        fig.colorbar(im, location="left").set_label(label)
        ax.set_xlabel(r"$x$ (kpc)")
        ax.set_ylabel(r"$y$ (kpc)")
        ax.set_zlabel(r"$z$ (kpc)")
        ax.set_box_aspect([1, 1, 1])
        p3 = os.path.join(odir, f"predict-{tag}-test-3D.pdf")
        fig.savefig(p3, dpi=300, transparent=True)
        plt.close(fig)
        written.append(p3)
        if in_slice.any():
            fig, ax = plt.subplots(figsize=(6, 6))
            im = ax.scatter(xtest[in_slice, 0], xtest[in_slice, 1], c=vals[in_slice])
            fig.colorbar(im).set_label(label)
            ax.set_xlabel(r"$x$ (kpc)")
            ax.set_ylabel(r"$y$ (kpc)")
            ax.set_aspect("equal")
            fig.tight_layout()
            p2 = os.path.join(odir, f"predict-{tag}-test-2D.pdf")
            fig.savefig(p2, dpi=300, transparent=True)
            plt.close(fig)
            written.append(p2)
    return written


def plot_error_boxes(error_df: Mapping[str, Sequence], error_types=None, path=None):
    """Per-model boxplots of test-error statistics.  ``error_df`` maps a
    column name to its values (the JAX function's DataFrame columns:
    ``model`` and the error columns such as ``f mse``)."""
    plt = _plt()
    cols = {k: np.asarray(v) for k, v in error_df.items()}
    model_col = cols["model"]

    def finite(v):
        v = np.asarray(v, dtype=float)
        return v[~np.isnan(v)]

    if error_types is None:
        error_types = [c for c in ("f mse", "f mae", "f loglike", "f chisq",
                                   "e mse", "e mae", "e loglike", "e chisq")
                       if c in cols and finite(cols[c]).size]
    models = list(dict.fromkeys(model_col.tolist()))
    fig, axes = plt.subplots(1, len(error_types), figsize=(4 * len(error_types), 4),
                             squeeze=False)
    for ax, et in zip(axes[0], error_types):
        data = [finite(cols[et][model_col == m]) for m in models]
        ax.boxplot(data, tick_labels=models, showfliers=False)
        ax.set_title(et)
        ax.tick_params(axis="x", rotation=30)
    return _save(fig, path)


def matplotlib_available() -> bool:
    """True when matplotlib imports (the card's machine has none)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True
