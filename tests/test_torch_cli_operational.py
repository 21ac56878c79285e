"""The port's operational CLIs (``cli.infer``, ``cli.validate``) and the
training CLI's real-archive paths against the JAX package's, on the CPU.

The world is tests/test_cli_operational.py's, written in the test by the
JAX writers: a 40x44 DEM with sea rows, a January of hourly ERA5
temperature, six stations in the legacy layout, and a cnp model (U-Net
(8,), density 24, float32) the JAX package trains on ten days; then a WRF
cycle on a curvilinear grid and a humidity year file for the training
scenarios. Each of that file's five scenarios runs through both packages'
CLIs on the same archives and the same data paths, the port with
``--device cpu``.

Tolerances: the port's prediction files read in the JAX package within
tests/test_torch_validate_era.py's float32 bound, rtol 1e-4 with an atol
of 1e-5 times the field's largest magnitude (both CLIs run float32
transfers and uploads here); the held-out RMSE to rtol 1e-4 and its count
exactly. Training: the YAML has no compute dtype, so both sides'
``initialise_model`` are wrapped to build float32 models, and the port
starts from the JAX initial parameters unless it warm-starts, as
tests/test_torch_cli_train.py does; the processor and the tasks bit for
bit, the losses to rtol 1e-4 (its bound for float32 steps in other
summation orders).
"""

import json
import os
from datetime import datetime

import jax
import numpy as np
import pytest
import yaml

from deepsensornz_tpu import paths as jpaths
from deepsensornz_tpu.cli import infer as jinfer
from deepsensornz_tpu.cli import train_downscaling as jtrain_cli
from deepsensornz_tpu.cli import validate as jvalidate_cli
from deepsensornz_tpu.data.grid import Dataset, Field, open_dataset, save_dataset
from deepsensornz_tpu.data.sources.era5 import ERA5Source
from deepsensornz_tpu.data.sources.stations import StationSource, save_station_file
from deepsensornz_tpu.data.sources.wrf import WRFSource
from deepsensornz_tpu.pipeline.preprocess import PreprocessForDownscaling
from deepsensornz_tpu.pipeline.train import Train as JTrain
from deepsensornz_tpu_torch import paths
from deepsensornz_tpu_torch.cli import infer as tinfer
from deepsensornz_tpu_torch.cli import train_downscaling as ttrain_cli
from deepsensornz_tpu_torch.cli import validate as tvalidate_cli
from deepsensornz_tpu_torch.pipeline.train import Train
from deepsensornz_tpu_torch.pipeline.validate import load_run
from deepsensornz_tpu_torch.train.checkpoint import params_from_jax
from test_torch_pipeline import assert_same_task

YEAR = 2020
F32 = ["--transfer_dtype", "none", "--upload_dtype", "none"]


def _close(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * float(np.nanmax(np.abs(want))))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("world")
    nlat, nlon = 40, 44
    lat = np.linspace(-34.0, -47.0, nlat)
    lon = np.linspace(166.0, 178.0, nlon)
    rng = np.random.default_rng(0)
    dem_data = np.abs(rng.normal(300, 200, (nlat, nlon)))
    dem_data[:4, :] = np.nan
    dem = Field(dem_data, ("latitude", "longitude"), {"latitude": lat, "longitude": lon},
                "elevation")
    os.makedirs(root / "topo")
    save_dataset(Dataset([dem]), str(root / "topo" / "dem.nc"), float32=False)

    os.makedirs(root / "era5" / "temperature")
    t = np.datetime64(f"{YEAR}-01-01", "s") + np.arange(31 * 24) * np.timedelta64(1, "h")
    blat, blon = np.linspace(-34.0, -47.0, 14), np.linspace(166.0, 178.0, 15)
    base = Field(12 + 3 * rng.standard_normal((len(t), 14, 15)), ("time", "latitude", "longitude"),
                 {"time": t, "latitude": blat, "longitude": blon}, "t2m")
    save_dataset(Dataset([base]), str(root / "era5" / "temperature" / f"t2m_{YEAR}.nc"),
                 float32=False)

    os.makedirs(root / "stations")
    names = []
    for i in range(6):
        name = f"st{i:02d}"
        save_station_file(str(root / "stations" / f"{name}.nc"), name,
                          float(rng.uniform(-46, -35)), float(rng.uniform(167, 177)),
                          float(rng.uniform(5, 800)), t,
                          {"dry_bulb": 12 + 3 * rng.standard_normal(len(t))})
        names.append(name)

    era5 = ERA5Source(str(root / "era5"))
    src = era5.load("temperature", [YEAR])
    stations = StationSource(str(root / "stations")).load_stations_time(
        "temperature", src.coords["time"][: 10 * 24])
    processed = PreprocessForDownscaling(variable="temperature").run_processing_sequence(
        dem, {"temperature": src.isel(time=np.arange(10 * 24))}, stations,
        highres_factor=2, lowres_factor=4, daily=True)
    training = JTrain(processed)
    training.setup_task_loader(station_as_context="all", internal_density=24)
    training.initialise_model(unet_channels=(8,), likelihood="cnp", compute_dtype="float32",
                              decoder_channels=8, mlp_hidden=8)
    training.train_model(n_epochs=1, batch_size=4, lr=1e-3, verbose=False,
                         model_dir=str(root / "models" / "temperature" / "m0"))

    # a WRF cycle and a humidity year file for the training scenarios
    wsrc = WRFSource(str(root / "wrf"), weights_dir="")
    init = datetime(YEAR, 1, 5)
    ny, nx = 12, 14
    wlat = np.linspace(-47, -34, ny)[:, None] + np.linspace(0, 0.5, nx)[None, :]
    wlon = np.linspace(166, 178, nx)[None, :] + np.linspace(0, 0.3, ny)[:, None]
    wrng = np.random.default_rng(5)
    for valid in wsrc.cycle_hours(init):
        path = wsrc.filename_for(init, valid)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_dataset(Dataset({"T2": Field(285 + wrng.standard_normal((ny, nx)), ("y", "x"), {},
                                          "T2"),
                              "XLAT": Field(wlat, ("y", "x"), {}, "XLAT"),
                              "XLONG": Field(wlon, ("y", "x"), {}, "XLONG")}),
                     path, float32=False)
    os.makedirs(root / "era5" / "humidity")
    hrng = np.random.default_rng(9)
    rh = Field(np.clip(60 + 20 * hrng.standard_normal((len(t), 14, 15)), 1, 100),
               ("time", "latitude", "longitude"),
               {"time": t, "latitude": blat, "longitude": blon}, "rh")
    save_dataset(Dataset([rh]), str(root / "era5" / "humidity" / f"rh_{YEAR}.nc"), float32=False)
    return root, names


def _paths(root, models):
    return {"era5": {"parent": str(root / "era5")}, "stations": {"parent": str(root / "stations")},
            "topography": {"file": str(root / "topo" / "dem.nc")},
            "wrf": {"parent": str(root / "wrf")}, "save_model": {"fpath": str(models)}}


@pytest.fixture
def data_paths(world, monkeypatch):
    """Both packages read the world; each writes its runs under its own
    ``save_model`` root (the JAX-trained ``m0`` is served from the JAX
    root by both)."""
    root, _ = world

    def set_paths(jmodels=root / "models", tmodels=root / "models"):
        monkeypatch.setattr(jpaths, "_DATA_PATHS", _paths(root, jmodels))
        monkeypatch.setattr(paths, "_DATA_PATHS", _paths(root, tmodels))

    set_paths()
    return set_paths


def test_infer_cli_end_to_end(world, data_paths, tmp_path, capsys):
    root, names = world
    argv = ["--var", "temperature", "--model_name", "m0", "--year", str(YEAR), "--months", "1",
            "--highres_factor", "2", "--remove_stations", names[0]] + F32
    jinfer.main(argv + ["--out_dir", str(tmp_path / "jax")])
    tinfer.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    rel = os.path.join("temperature", "m0", f"temperature_{YEAR}_01.nc")
    got, want = open_dataset(str(tmp_path / "port" / rel)), open_dataset(str(tmp_path / "jax" / rel))
    assert list(got) == list(want) == ["mean"]  # mean only
    assert got["mean"].sizes()["time"] == 31 * 24
    for d in want["mean"].coords:
        np.testing.assert_array_equal(got["mean"].coords[d], want["mean"].coords[d])
    _close(got["mean"].data, want["mean"].data)
    for k in ("institution", "source", "variable", "model_name", "year", "month"):
        assert got.attrs[k] == want.attrs[k], k
    # a rerun skips the month that exists (resumable)
    capsys.readouterr()
    tinfer.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert "skip existing" in capsys.readouterr().out
    assert tinfer.DEFAULT_HOLDOUT_STATIONS == jinfer.DEFAULT_HOLDOUT_STATIONS
    np.testing.assert_array_equal(tinfer.month_hours(YEAR, 12), jinfer.month_hours(YEAR, 12))


def test_infer_cli_int16_default_transfer(world, data_paths, tmp_path):
    """The CLI's default transfer (int16 maps, float16 uploads): one
    quantum of each task's map beside the float32 bound."""
    root, names = world
    argv = ["--var", "temperature", "--model_name", "m0", "--year", str(YEAR), "--months", "1",
            "--highres_factor", "2", "--remove_stations", names[0]]
    jinfer.main(argv + ["--out_dir", str(tmp_path / "jax")])
    tinfer.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    rel = os.path.join("temperature", "m0", f"temperature_{YEAR}_01.nc")
    got = open_dataset(str(tmp_path / "port" / rel))["mean"].data
    want = open_dataset(str(tmp_path / "jax" / rel))["mean"].data
    step = (np.nanmax(want, axis=(1, 2), keepdims=True)
            - np.nanmin(want, axis=(1, 2), keepdims=True)) / (2 ** 16 - 1)
    tol = 1e-4 * np.abs(want) + 1e-5 * float(np.nanmax(np.abs(want))) + step
    land = ~np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), ~land)
    assert (np.abs(got - want)[land] <= np.broadcast_to(tol, want.shape)[land]).all()


def test_validate_cli_end_to_end(world, data_paths, tmp_path):
    root, names = world
    argv = ["--var", "temperature", "--model_name", "m0", "--year", str(YEAR), "--months", "1",
            "--highres_factor", "2", "--remove_stations", names[0], names[1]]
    jvalidate_cli.main(argv + ["--out_dir", str(tmp_path / "jax")])
    tvalidate_cli.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    sub = os.path.join("temperature", "m0")
    metrics = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / sub / "metrics.json") as f:
            metrics[side] = json.load(f)
    key = f"{YEAR}-01"
    got, want = metrics["port"][key], metrics["jax"][key]
    assert got["n_holdout_obs"] == want["n_holdout_obs"] > 0
    assert got["holdout_rmse"] == pytest.approx(want["holdout_rmse"], rel=1e-4)
    name = f"val_temperature_{YEAR}_01.nc"
    g, w = open_dataset(str(tmp_path / "port" / sub / name)), open_dataset(
        str(tmp_path / "jax" / sub / name))
    assert list(g) == list(w) == ["mean", "std"]
    for k in ("mean", "std"):
        _close(g[k].data, w[k].data)


@pytest.fixture
def float32_runs(monkeypatch):
    """Both ``Train.initialise_model``s build float32 models; the port's
    starts from the JAX one's initial parameters (unless it warm-starts).
    Yields the trainers of the runs, by side, in order."""
    seen = {"init": [], "jax": [], "port": []}
    jinit, tinit = JTrain.initialise_model, Train.initialise_model
    jfit, tfit = JTrain.train_model, Train.train_model

    def j_initialise(self, *a, **kw):
        model = jinit(self, *a, compute_dtype="float32", **kw)
        seen["init"].append(jax.device_get(self.params))
        return model

    def t_initialise(self, *a, **kw):
        model = tinit(self, *a, compute_dtype="float32", **kw)
        if kw.get("pretrained_dir") is None:
            self.params = params_from_jax(seen["init"][len(seen["port"])], model.cfg.upsample)
        return model

    def keep(side, fn):
        def train(self, *a, **kw):
            out = fn(self, *a, **kw)
            seen[side].append((self, out))
            return out
        return train

    monkeypatch.setattr(JTrain, "initialise_model", j_initialise)
    monkeypatch.setattr(Train, "initialise_model", t_initialise)
    monkeypatch.setattr(JTrain, "train_model", keep("jax", jfit))
    monkeypatch.setattr(Train, "train_model", keep("port", tfit))
    return seen


def _train_both(args: dict, tmp_path, name: str) -> tuple[str, str]:
    """The YAML through the JAX CLI, then the port's; their run dirs."""
    arg_path = tmp_path / f"{name}.yaml"
    arg_path.write_text(yaml.safe_dump(args))
    jdir = jtrain_cli.main(["-arg_path", str(arg_path)])
    tdir = ttrain_cli.main(["-arg_path", str(arg_path), "--device", "cpu"])
    return jdir, tdir


def _same_training(seen, k=-1):
    (jt, jout), (tt, tout) = seen["jax"][k], seen["port"][k]
    assert tt.dp.to_dict() == jt.dp.to_dict()
    times = tt.task_times()
    np.testing.assert_array_equal(times, jt.task_times())
    assert_same_task(jt.create_tasks(times[:3], datewise_deterministic=True),
                     tt.create_tasks(times[:3], datewise_deterministic=True))
    np.testing.assert_allclose(tout["train_losses"], jout["train_losses"], rtol=1e-4)
    np.testing.assert_allclose(tout["val_losses"], jout["val_losses"], rtol=1e-4)


def test_train_cli_real_archive(world, data_paths, float32_runs, tmp_path):
    root, names = world
    data_paths(tmp_path / "jax", tmp_path / "port")
    args = {"variable": "temperature", "model_name": "cli_real", "train_start_year": YEAR,
            "train_end_year": YEAR, "n_epochs": 1, "batch_size": 4, "lr": 1e-3,
            "unet_channels": [8], "likelihood": "cnp", "internal_density": 24,
            "highres_coarsen_factor": 2, "lowres_coarsen_factor": 4,
            "remove_stations": [names[0]]}
    jdir, tdir = _train_both(args, tmp_path, "real")
    assert tdir == str(tmp_path / "port" / "temperature" / "cli_real")
    assert os.path.exists(os.path.join(tdir, "args.yaml"))
    _same_training(float32_runs)
    run = load_run(tdir, device="cpu")
    tl = run["task_loader"]
    for frame in [tl.target] + [c for c in tl.context if hasattr(c, "columns")]:
        key = "station_name" if "station_name" in frame.columns else "station_id"
        assert names[0] not in set(frame[key].astype(str))
    assert len(float32_runs["port"][-1][0].task_times()) == 31  # daily


def test_train_cli_wrf_base(world, data_paths, float32_runs, tmp_path):
    """Midnight-init cycle, every second hourly file, hourly stations: the
    Delaunay regrid onto the topography, then the same training."""
    data_paths(tmp_path / "jax", tmp_path / "port")
    args = {"variable": "temperature", "base": "wrf", "model_name": "cli_wrf",
            "start_init": f"{YEAR}0105", "time_intervals": 2, "n_epochs": 1, "batch_size": 4,
            "lr": 1e-3, "unet_channels": [8], "likelihood": "cnp", "internal_density": 24,
            "highres_coarsen_factor": 2, "lowres_coarsen_factor": 4}
    jdir, tdir = _train_both(args, tmp_path, "wrf")
    _same_training(float32_runs)
    tt = float32_runs["port"][-1][0]
    assert len(tt.task_times()) == 12  # 24 hourly files, every second one
    raw, jraw = tt.p["raw"]["base"]["t2m"], float32_runs["jax"][-1][0].p["raw"]["base"]["t2m"]
    np.testing.assert_array_equal(raw.data, jraw.data)  # the regrid, bitwise


def test_train_cli_warmstart_context_auto_density(world, data_paths, float32_runs, tmp_path):
    """A second ERA5 variable as context, ``era5_coarsen_factor``, the
    automatic density, and a warm start whose encoder stays frozen."""
    data_paths(tmp_path / "jax", tmp_path / "port")
    common = {"variable": "temperature", "train_start_year": YEAR, "train_end_year": YEAR,
              "n_epochs": 1, "batch_size": 4, "lr": 1e-3, "unet_channels": [8],
              "likelihood": "cnp", "context_variables": ["humidity"], "era5_coarsen_factor": 2,
              "auto_set_internal_density": True, "highres_coarsen_factor": 2,
              "lowres_coarsen_factor": 4}
    jpre, tpre = _train_both({**common, "model_name": "cli_pre"}, tmp_path, "pre")
    _same_training(float32_runs)
    # each side warm-starts from its own pre-trained run
    arg = tmp_path / "warm.yaml"
    warm = {**common, "model_name": "cli_warm", "lr": 1e-2}
    arg.write_text(yaml.safe_dump({**warm, "pretrained_model": jpre}))
    jtrain_cli.main(["-arg_path", str(arg)])
    arg.write_text(yaml.safe_dump({**warm, "pretrained_model": tpre}))
    tdir = ttrain_cli.main(["-arg_path", str(arg), "--device", "cpu"])
    (jt, jout), (tt, tout) = float32_runs["jax"][-1], float32_runs["port"][-1]
    assert tt.internal_density == jt.internal_density > 0
    np.testing.assert_allclose(tout["train_losses"], jout["train_losses"], rtol=1e-4)
    pre_p = load_run(tpre, device="cpu")["params"]
    warm_p = load_run(tdir, device="cpu")["params"]
    enc = [k for k in pre_p if k.startswith(("unet", "ls_grid", "ls_points"))]
    head = [k for k in pre_p if k.startswith("head_out")]
    assert enc and head
    for k in enc:
        assert (pre_p[k] == warm_p[k]).all(), k
    assert any(not (pre_p[k] == warm_p[k]).all() for k in head)
    with open(os.path.join(tdir, "metadata.json")) as f:
        assert json.load(f)["model_config"]["internal_density"] == tt.internal_density
