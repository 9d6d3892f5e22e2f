"""The PyTorch port's support modules (hipgp_tpu_torch.viz, utils.profiling,
utils.naming) and the harness's figures, against the JAX package where it
has the same function.

Each `viz` function writes a non-empty file; the harness with
``make_plots=True`` writes the figure files the JAX harness writes, and with
``make_plots=None`` and matplotlib hidden (a subprocess with
``sys.modules['matplotlib'] = None``) it skips them with its one line;
`PhaseTimer` gives the JAX timer's rows and CSV columns; `trace` writes a
Chrome trace on the CPU; `naming` gives the JAX strings and JSON.
"""
import csv
import datetime
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu.experiments import harness as jharness
from hipgp_tpu.utils import naming as jnaming
from hipgp_tpu.utils import profiling as jprofiling
from hipgp_tpu_torch import viz
from hipgp_tpu_torch.experiments import harness
from hipgp_tpu_torch.utils import naming, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nonempty(path):
    return os.path.exists(path) and os.path.getsize(path) > 0


def test_every_viz_function_writes_a_file(tmp_path):
    rng = np.random.default_rng(0)
    g = rng.standard_normal((12, 10))
    extent = (0, 1, 0, 1)
    viz.plot_comparison(g, g + 0.1, extent, path=str(tmp_path / "cmp.jpg"))
    viz.plot_elbo_trace(np.cumsum(rng.random(30)), path=str(tmp_path / "elbo.jpg"))
    viz.plot_posterior_grid(g.ravel(), np.abs(g).ravel(), (12, 10), extent,
                            path=str(tmp_path / "post.jpg"))
    z = rng.standard_normal(200)
    viz.plot_qq({"a": z, "b": 1.2 * z}, path=str(tmp_path / "qq.pdf"))
    viz.plot_zscore_histogram(np.append(z, np.nan), path=str(tmp_path / "hist.pdf"))
    x3 = rng.uniform(-1, 1, (60, 3))
    e = np.abs(rng.standard_normal(60)) + 0.1
    written = viz.plot_domain_result(str(tmp_path), {
        "xtest": x3, "etest": e, "emu_test": e + 0.05 * rng.standard_normal(60),
        "esig_test": np.full(60, 0.1)}, slice_center=0.0, slice_halfwidth=0.3)
    assert len(written) == 10 and all(_nonempty(p) for p in written)
    assert viz.plot_domain_result(str(tmp_path), {"xtest": x3[:, :2]}) == []
    frame = {"model": ["m1"] * 5 + ["m2"] * 5, "f mse": rng.random(10),
             "f mae": np.r_[rng.random(9), np.nan], "e mse": np.full(10, np.nan)}
    viz.plot_error_boxes(frame, path=str(tmp_path / "boxes.pdf"))
    for name in ("cmp.jpg", "elbo.jpg", "post.jpg", "qq.pdf", "hist.pdf", "boxes.pdf"):
        assert _nonempty(tmp_path / name), name
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    assert viz.plot_smooth(ax, g, *extent) is not None
    assert viz.ax_scatter(ax, rng.random((5, 2))) is not None
    plt.close(fig)


def _harness_run(mod, odir, **kw):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (120, 2))
    f = lambda a: np.sin(3 * a[:, 0]) * np.cos(2 * a[:, 1])
    g = np.linspace(-1, 1, 6)
    xg = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    return mod.fit_predict_and_save(
        "run", x, f(x) + 0.1 * rng.standard_normal(120), np.full(120, 0.1),
        [np.linspace(-1, 1, 8)] * 2, ell_init=0.4, sig2_init=1.0, fit_method="full-batch",
        xtest=x[:40], ftest=f(x[:40]), xgrid=xg, fgrid=f(xg), grid_shape=(6, 6),
        grid_extent=(-1, 1, -1, 1), output_dir=str(odir), **kw)


def test_harness_writes_the_jax_figures(tmp_path):
    # make_plots (the default None: matplotlib imports here) writes the
    # figure files the JAX harness writes, by the same names
    _harness_run(jharness, tmp_path / "jax", dtype=jnp.float64)
    _harness_run(harness, tmp_path / "port", dtype=torch.float64, device="cpu")
    figs = lambda d: sorted(n for n in os.listdir(d) if n.endswith((".jpg", ".pdf")))
    want = figs(tmp_path / "jax" / "run")
    assert want == ["comparison-grid.jpg", "elbo.jpg", "f-zscore-histogram.pdf",
                    "posterior-grid.jpg", "qq.pdf"]
    assert figs(tmp_path / "port" / "run") == want
    assert all(_nonempty(tmp_path / "port" / "run" / n) for n in want)


def test_make_plots_none_skips_without_matplotlib(tmp_path):
    # matplotlib hidden: the harness prints its one line and writes no figure;
    # make_plots=True raises ImportError
    code = f"""
import sys
sys.modules['matplotlib'] = None
import numpy as np, torch
sys.path.insert(0, {REPO!r})
from hipgp_tpu_torch.experiments import harness
from hipgp_tpu_torch.models import HIPGP
from hipgp_tpu_torch.kernels import SqExp
m = HIPGP(SqExp(), [np.linspace(0, 1, 6)] * 2, num_obs=10, dtype=torch.float64, device='cpu')
x = np.random.default_rng(0).uniform(0, 1, (10, 2))
harness.evaluate_and_save({str(tmp_path / 'a')!r}, m, m.init_state(), xtest=x,
                          ftest=x[:, 0], elbo_trace=[1.0, 2.0])
try:
    harness.evaluate_and_save({str(tmp_path / 'b')!r}, m, m.init_state(), xtest=x,
                              ftest=x[:, 0], make_plots=True, elbo_trace=[1.0])
except ImportError:
    print('raised ImportError')
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("figures skipped: matplotlib is not installed") == 1
    assert "raised ImportError" in out.stdout
    assert (tmp_path / "a" / "predictions.npz").exists()
    assert not [n for n in os.listdir(tmp_path / "a") if n.endswith((".jpg", ".pdf"))]


def test_phase_timer_rows_and_csv_match_jax(tmp_path):
    tt, jt = profiling.PhaseTimer(), jprofiling.PhaseTimer()
    for timer in (tt, jt):
        for phase in ("fit", "predict", "fit"):
            with timer(phase):
                pass
    rows = tt.report()
    jdf = jt.report()
    assert [r["phase"] for r in rows] == list(jdf.index)
    assert [r["calls"] for r in rows] == list(jdf["calls"]) == [2, 1]
    for r in rows:
        assert r["mean_s"] == pytest.approx(r["total_s"] / r["calls"])
    tt.to_csv(str(tmp_path / "t.csv"))
    jt.to_csv(str(tmp_path / "j.csv"))
    with open(tmp_path / "t.csv") as f, open(tmp_path / "j.csv") as g:
        got, want = list(csv.reader(f)), list(csv.reader(g))
    assert got[0] == want[0] == ["phase", "total_s", "calls", "mean_s"]
    assert [r[0] for r in got] == [r[0] for r in want] and len(got) == 3


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        torch.randn(64, 64) @ torch.randn(64, 64)
    path = tmp_path / "tr" / "trace.json"
    assert _nonempty(path)
    events = json.load(open(path))["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_naming_matches_jax():
    s = naming.add_date_time("run")
    j = jnaming.add_date_time("run")
    assert s.startswith("run_D") and len(s) == len(j) == len("run_D") + 13
    d = datetime.datetime.strptime(s[len("run_D"):], "%y%m%d_%H%M%S")
    assert abs((datetime.datetime.now() - d).total_seconds()) < 60
    obj = {"a": np.int64(3), "b": np.float32(0.5), "c": np.arange(3), "d": [1, 2]}
    assert (json.dumps(obj, cls=naming.NumpyEncoder)
            == json.dumps(obj, cls=jnaming.NumpyEncoder))
    assert json.dumps({"t": torch.tensor(2.5), "v": torch.arange(2)},
                      cls=naming.NumpyEncoder) == '{"t": 2.5, "v": [0, 1]}'
    with pytest.raises(TypeError):
        json.dumps({"x": object()}, cls=naming.NumpyEncoder)


def test_print_vec_matches_jax(capsys):
    v = np.array([-3.0, 0.5, 2.0])
    jnaming.print_vec("v", jnp.asarray(v))
    want = capsys.readouterr().out
    naming.print_vec("v", torch.as_tensor(v))
    assert capsys.readouterr().out == want
