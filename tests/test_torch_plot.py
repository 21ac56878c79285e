"""The port's plotting suite (``deepsensornz_tpu_torch.plot``) against the
JAX package's on the Agg backend: every function renders, and on the same
inputs the port's figure holds the JAX figure's data (each axes' title,
labels and limits, its images' and meshes' arrays, its scatter offsets
and colours, its lines' data, its patches and texts; the number of axes).

``plot_context_encoding`` takes the port's ``ConvNP`` and encodes at the
model's own length-scales (``model.lengthscale``: softplus of the raw
parameter plus the floor of half a grid step). The JAX function reads
softplus of the raw parameter alone, without the floor its model adds; so
the JAX function is fed the carried-over parameters with each length-scale
entry moved to the raw value whose softplus is the model's length-scale.
Its images match within f32 rounding (1e-5 of the largest value), the
rest exactly.

Also: the port's ``Train`` writes ``losses.png`` beside the checkpoint,
and, with matplotlib blocked, skips it with one printed line while every
other module of the port imports (matplotlib is imported by ``plot`` only).
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")

from deepsensornz_tpu import plot as jplot  # noqa: E402
from deepsensornz_tpu.data import grid as jgrid  # noqa: E402
from deepsensornz_tpu.data.processor import DataProcessor as JProcessor  # noqa: E402
from deepsensornz_tpu.data.synthetic import synthetic_bundle  # noqa: E402
from deepsensornz_tpu.models.convnp import ConvNP as JConvNP  # noqa: E402
from deepsensornz_tpu.models.convnp import ConvNPConfig as JConfig  # noqa: E402
from deepsensornz_tpu.task.loader import TaskLoader  # noqa: E402
from deepsensornz_tpu_torch import plot  # noqa: E402
from deepsensornz_tpu_torch.data import grid  # noqa: E402
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig  # noqa: E402
from deepsensornz_tpu_torch.task.task import TaskBatch  # noqa: E402
from deepsensornz_tpu_torch.train.checkpoint import params_from_jax  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PLT = matplotlib.pyplot


def _arr(a) -> np.ndarray:
    return np.ma.filled(np.ma.asarray(a, dtype=float), np.nan)


def signature(fig) -> list:
    """What a figure shows, axes by axes."""
    out = []
    for ax in fig.axes:
        out.append({
            "text": (ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                     [t.get_text() for t in ax.texts],
                     [t.get_text() for t in ax.get_xticklabels()]),
            "limits": np.array([*ax.get_xlim(), *ax.get_ylim()]),
            "images": [_arr(im.get_array()) for im in ax.images],
            "collections": [(type(c).__name__,
                             None if c.get_array() is None else _arr(c.get_array()),
                             _arr(c.get_offsets())) for c in ax.collections],
            "lines": [_arr(line.get_xydata()) for line in ax.lines],
            "patches": [(type(p).__name__, _arr(p.get_path().vertices),
                         _arr(p.get_transform().get_matrix())) for p in ax.patches],
        })
    return out


def assert_same_figure(got, want, rtol=0.0):
    a, b = signature(got), signature(want)
    assert len(a) == len(b), (len(a), len(b))
    for i, (x, y) in enumerate(zip(a, b)):
        assert x["text"] == y["text"], (i, x["text"], y["text"])
        for key in ("limits", "images", "lines"):
            xs, ys = (x[key], y[key]) if key != "limits" else ([x[key]], [y[key]])
            assert len(xs) == len(ys), (i, key)
            for u, v in zip(xs, ys):
                scale = float(np.nanmax(np.abs(v))) if v.size else 0.0
                np.testing.assert_allclose(u, v, rtol=rtol, atol=rtol * scale, equal_nan=True,
                                           err_msg=f"axes {i} {key}")
        for key in ("collections", "patches"):
            assert len(x[key]) == len(y[key]), (i, key)
            for u, v in zip(x[key], y[key]):
                assert u[0] == v[0]
                for p, q in zip(u[1:], v[1:]):
                    if p is None or q is None:
                        assert p is None and q is None
                    else:
                        np.testing.assert_allclose(p, q, equal_nan=True,
                                                   err_msg=f"axes {i} {key}")
    PLT.close(got)
    PLT.close(want)


# -- inputs, built once for both packages ---------------------------------------------


def _fields(mod, n_t=2, h=20, w=24, seed=0):
    lat = np.linspace(-34, -47, h)
    lon = np.linspace(166, 178, w)
    t = np.array(["2020-01-01", "2020-01-02"], dtype="datetime64[ns]")[:n_t]
    rng = np.random.default_rng(seed)
    dims = ("time", "latitude", "longitude")
    coords = {"time": t, "latitude": lat, "longitude": lon}

    def mk(name):
        return mod.Field(rng.random((n_t, h, w)), dims, coords, name)

    mean, std, base = mk("mean"), mk("std"), mk("t2m")
    mean.data[:, :3, :4] = np.nan  # sea
    samples = mod.Field(rng.random((3, n_t, h, w)), ("sample",) + dims,
                        {"sample": np.arange(3), **coords}, "samples")
    pred = mod.Dataset({"mean": mean, "std": std, "samples": samples})
    return pred, base


def _both(fn):
    """``fn(plot module, grid module)`` for the port, then for JAX."""
    return fn(plot, grid), fn(jplot, jgrid)


@pytest.fixture(scope="module")
def stations():
    rng = np.random.default_rng(1)
    return rng.uniform(-46, -35, 8), rng.uniform(167, 177, 8), rng.random(8)


CASES = {
    "plot_field": lambda p, g: p.plot_field(_fields(g)[0]["mean"].isel(time=0), title="t"),
    "plot_field_on_axes": lambda p, g: p.plot_field(
        _fields(g)[1].isel(time=1), ax=PLT.subplots()[1], cmap="Greys_r", vmin=0.1, vmax=0.9,
        colorbar=False),
    "plot_prediction": lambda p, g: p.plot_prediction(_fields(g)[0], time_idx=1),
    "plot_prediction_stations": lambda p, g: p.plot_prediction(
        _fields(g)[0], station_coords=np.array([[-40.0, 170.0], [-38.0, 175.0]])),
    "plot_samples": lambda p, g: p.plot_samples(_fields(g)[0], time_idx=1, n=2),
    "gen_test_fig": lambda p, g: p.gen_test_fig(
        _fields(g)[1], _fields(g)[0], time_idx=1, n_samples=2,
        sea_mask=np.isnan(_fields(g)[0]["mean"].data[1])),
    "gen_test_fig_base_only": lambda p, g: p.gen_test_fig(_fields(g)[1].isel(time=0)),
    "plot_base_and_prediction": lambda p, g: p.plot_base_and_prediction(
        _fields(g)[1], _fields(g)[0], location="wellington", var_label="T"),
    "plot_base_and_prediction_nationwide": lambda p, g: p.plot_base_and_prediction(
        _fields(g)[1], _fields(g)[0], time_idx=1),
    "plot_timeseries_comparison": lambda p, g: p.plot_timeseries_comparison(
        np.arange(5.0), np.linspace(0, 1, 5), np.full(5, 0.2), obs=np.arange(5.0) / 4,
        base=np.ones(5), title="station"),
    "make_loss_plot": lambda p, g: p.make_loss_plot([3.0, 2.0, 1.0], [3.1, 2.2, 1.5]),
    "plot_calibration": lambda p, g: p.plot_calibration(
        np.append(np.random.default_rng(0).standard_normal(300), np.nan), bins=20),
    "plot_elevation_band_errors": lambda p, g: p.plot_elevation_band_errors(
        {"0-500": [1.0, 1.5, 2.0], "500-1000": [2.0, 2.5]},
        {"0-500": [1.2, 1.8], "500-1000": [2.2, 3.0, 2.9]}),
    "plot_elevation_band_errors_alone": lambda p, g: p.plot_elevation_band_errors(
        {"0-500": [1.0, 1.5, 2.0]}, ylabel="MAE"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_figure_matches_jax(case):
    assert_same_figure(*_both(CASES[case]))


def test_station_figures_match_jax(stations):
    lat, lon, val = stations
    assert_same_figure(*_both(lambda p, g: p.plot_errors_at_stations(lat, lon, val - 0.5)))
    assert_same_figure(*_both(lambda p, g: p.plot_stations_and_prediction(
        _fields(g)[0], lat, lon, val, base_field=_fields(g)[1], variable="precipitation")))
    assert_same_figure(*_both(lambda p, g: p.plot_stations_and_prediction(
        _fields(g)[0], lat, lon, val, time_idx=1)))
    for kw in ({"location": (-41.3, 174.8), "zoom_to_location": True,
                "labels": {(-41.3, 174.8): "0.42"}}, {"location": "dunedin"}, {}):
        assert_same_figure(*_both(lambda p, g: p.plot_prediction_with_stations(
            _fields(g)[0], lat, lon, **kw)))


def test_helpers_match_jax():
    pred, _ = _fields(grid)
    jpred, _ = _fields(jgrid)
    for loc in ("wellington", (-40.0, 179.5)):
        assert plot._resolve_location(loc) == jplot._resolve_location(loc)
        assert plot._zoom_extent(loc) == jplot._zoom_extent(loc)
    rng = ((-43.0, -39.0), (170.0, 175.0))
    got, want = plot._sel_window(pred, *rng), jplot._sel_window(jpred, *rng)
    for k in ("mean", "std"):
        np.testing.assert_array_equal(got[k].data, want[k].data)
    ax, jax_ = PLT.subplots()[1], PLT.subplots()[1]
    for a, b in zip(plot._map_axes(ax, pred["mean"]), jplot._map_axes(jax_, jpred["mean"])):
        np.testing.assert_array_equal(a, b)
    assert (ax.get_xlabel(), ax.get_ylabel()) == (jax_.get_xlabel(), jax_.get_ylabel())
    PLT.close("all")


@pytest.fixture(scope="module")
def encoding_setting():
    base, dem, stations = synthetic_bundle(n_times=2, base_hw=(8, 8), dem_hw=(16, 16),
                                           n_stations=6)
    dp = JProcessor()
    dp.set_coord_maps_from_extent(-47, -34, 166, 178)
    tl = TaskLoader(context=[dp(base, method="mean_std"), dp(stations, method="mean_std")],
                    target=dp(stations), internal_density=16, grid_multiple=16)
    jtask = tl([base.coords["time"][0]])
    jcfg = JConfig(unet_channels=(8,), likelihood="cnp", internal_density=16,
                   decoder_channels=8, mlp_hidden=8, compute_dtype="float32")
    jparams = jax.device_get(JConvNP(jcfg).init(jax.random.key(0), jtask))
    task = TaskBatch.from_numpy(jtask)
    import dataclasses

    model = ConvNP.from_task(ConvNPConfig(**dataclasses.asdict(jcfg)), task)
    model.load_state_dict(params_from_jax(jparams, jcfg.upsample))
    return jtask, jparams, task, model


def test_plot_task_matches_jax(encoding_setting):
    jtask, _, task, _ = encoding_setting
    assert_same_figure(plot.plot_task(task), jplot.plot_task(jtask))


@pytest.mark.parametrize("max_channels", [3, 8])
def test_plot_context_encoding_matches_jax(encoding_setting, max_channels):
    jtask, jparams, task, model = encoding_setting
    # the raw value whose softplus is the model's length-scale (see the docstring)
    moved = {k: (np.float32(math.log(math.expm1(float(model.lengthscale(k).detach()))))
                 if k.startswith("ls_") else v) for k, v in jparams["params"].items()}
    got = plot.plot_context_encoding(model, task, max_channels=max_channels)
    want = jplot.plot_context_encoding(JConvNP(JConfig()), {"params": moved}, jtask,
                                       max_channels=max_channels)
    assert len(got.axes) == min(max_channels, 4)  # density and one value, two context sets
    assert_same_figure(got, want, rtol=1e-5)


def test_train_writes_the_loss_plot(tmp_path):
    """The port's ``Train`` writes ``losses.png`` beside the checkpoint, the
    figure of ``make_loss_plot`` on its losses."""
    from deepsensornz_tpu_torch.data.synthetic import synthetic_bundle as port_bundle
    from deepsensornz_tpu_torch.pipeline.preprocess import PreprocessForDownscaling
    from deepsensornz_tpu_torch.pipeline.train import Train

    base, dem, st = port_bundle("temperature", n_times=6, base_hw=(12, 12), dem_hw=(48, 48),
                                n_stations=10)
    bundle = PreprocessForDownscaling("temperature").run_processing_sequence(
        dem, {"temperature": base}, st, highres_factor=2, lowres_factor=4)
    t = Train(bundle, device="cpu")
    t.setup_task_loader(internal_density=16)
    t.initialise_model(likelihood="cnp", unet_channels=(8,), compute_dtype="float32",
                       decoder_channels=8, mlp_hidden=8)
    run = tmp_path / "run"
    t.train_model(model_dir=str(run), n_epochs=2, batch_size=4, lr=1e-3, verbose=False)
    png = run / "losses.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert_same_figure(plot.make_loss_plot(t.train_losses, t.val_losses),
                       jplot.make_loss_plot(t.train_losses, t.val_losses))


_NO_MATPLOTLIB = """
import importlib, os, pkgutil, sys
import deepsensornz_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    if name != "deepsensornz_tpu_torch.plot":
        importlib.import_module(name)
assert "matplotlib" not in sys.modules, "a module besides plot imported matplotlib"
sys.modules["matplotlib"] = None
try:
    import deepsensornz_tpu_torch.plot
    raise SystemExit("plot imported without matplotlib")
except ImportError:
    pass
from deepsensornz_tpu_torch.pipeline.train import write_loss_plot
path = os.path.join(sys.argv[1], "losses.png")
assert write_loss_plot([1.0, 0.5], [1.1, 0.6], path) is False
assert not os.path.exists(path)
"""


def test_without_matplotlib_the_plot_is_skipped(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_MATPLOTLIB, str(tmp_path)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("losses.png not written"), proc.stdout
