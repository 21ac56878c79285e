"""The port's training CLI, argument schema, profiles and data paths against
the JAX package's (CPU).

One YAML drives both CLIs in synthetic mode (24 daily times, 24² base, 96²
DEM, 24 stations; highres 2, lowres 4, density 24, U-Net (8, 8), gnp,
two epochs at batch 7). The YAML has no compute dtype, so both sides'
``Train.initialise_model`` are wrapped to build float32 models, and the
port starts from the JAX initial parameters (``params_from_jax``), as
tests/test_torch_pipeline.py holds ``Train``. Tolerances: the data
processor and the tasks bit for bit; losses and ``std_scale`` rtol 1e-4
(float32 forwards and backwards in different summation orders over six
Adam steps).
"""

import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch
import yaml

from deepsensornz_tpu import config as jcfg
from deepsensornz_tpu import paths as jpaths
from deepsensornz_tpu import utils as jutils
from deepsensornz_tpu.cli import train_downscaling as jcli
from deepsensornz_tpu.pipeline.train import Train as JTrain
from deepsensornz_tpu.pipeline.validate import load_run as jload_run
from deepsensornz_tpu_torch import config as cfg
from deepsensornz_tpu_torch import paths
from deepsensornz_tpu_torch import utils
from deepsensornz_tpu_torch.cli import train_downscaling as cli
from deepsensornz_tpu_torch.data.processor import DataProcessor
from deepsensornz_tpu_torch.pipeline.train import Train
from deepsensornz_tpu_torch.pipeline.validate import load_run
from deepsensornz_tpu_torch.train.checkpoint import params_from_jax
from test_torch_pipeline import assert_same_task

ARGS = {
    "variable": "temperature", "model_name": "cli_run", "synthetic": True, "n_epochs": 2,
    "batch_size": 7, "lr": 0.001, "unet_channels": [8, 8], "likelihood": "gnp",
    "internal_density": 24, "highres_coarsen_factor": 2, "lowres_coarsen_factor": 4,
    "include_time_of_year": True,
}


def _write_args(path, args):
    with open(path, "w") as f:
        yaml.safe_dump(args, f)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    arg_path = _write_args(root / "args.yaml", ARGS)
    seen = {}
    jinit, jtrain = JTrain.initialise_model, JTrain.train_model
    tinit, ttrain = Train.initialise_model, Train.train_model

    def j_initialise(self, *a, **kw):
        model = jinit(self, *a, compute_dtype="float32", **kw)
        seen["init"] = jax.device_get(self.params)
        return model

    def t_initialise(self, *a, **kw):
        model = tinit(self, *a, compute_dtype="float32", **kw)
        self.params = params_from_jax(seen["init"], model.cfg.upsample)
        return model

    def keep(name, fn):
        def train(self, *a, **kw):
            seen[name] = (self, fn(self, *a, **kw))
            return seen[name][1]
        return train

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrain, "initialise_model", j_initialise)
        mp.setattr(JTrain, "train_model", keep("jax", jtrain))
        mp.setattr(Train, "initialise_model", t_initialise)
        mp.setattr(Train, "train_model", keep("port", ttrain))
        mp.setattr(jpaths, "_DATA_PATHS", {"save_model": {"fpath": str(root / "jax")}})
        mp.setattr(paths, "_DATA_PATHS", {"save_model": {"fpath": str(root / "port")}})
        jax_dir = jcli.main(["-arg_path", arg_path])
        port_dir = cli.main(["-arg_path", arg_path, "--device", "cpu"])
    return {"jax_dir": jax_dir, "port_dir": port_dir, "arg_path": arg_path,
            "jax": seen["jax"], "port": seen["port"], "init": seen["init"]}


def test_cli_writes_the_run_where_the_paths_say(runs, tmp_path):
    port_dir = runs["port_dir"]
    assert port_dir.endswith(os.path.join("port", "temperature", "cli_run"))
    assert sorted(os.listdir(port_dir)) == [
        "args.yaml", "data_processor.json", "metadata.json", "opt_state.pt", "params.msgpack",
        "params.pt", "task_loader.pkl"]
    with open(os.path.join(port_dir, "args.yaml"), "rb") as f, \
            open(runs["arg_path"], "rb") as g:
        assert f.read() == g.read()
    for name in ("args.yaml", "data_processor.json", "metadata.json", "params.msgpack",
                 "task_loader.pkl"):
        assert os.path.exists(os.path.join(runs["jax_dir"], name)), name


def test_cli_data_processor_matches_jax(runs):
    with open(os.path.join(runs["port_dir"], "data_processor.json")) as f:
        port = json.load(f)
    with open(os.path.join(runs["jax_dir"], "data_processor.json")) as f:
        want = json.load(f)
    assert port == want
    assert DataProcessor.load(os.path.join(runs["jax_dir"], "data_processor.json")).to_dict() \
        == DataProcessor.load(os.path.join(runs["port_dir"], "data_processor.json")).to_dict()


@pytest.mark.parametrize("kw", [{"datewise_deterministic": True}, {"seed_override": 3}])
def test_cli_tasks_match_jax(runs, kw):
    jt, tt = runs["jax"][0], runs["port"][0]
    assert tt.internal_density == jt.internal_density == 24
    np.testing.assert_array_equal(tt.task_times(), jt.task_times())
    assert_same_task(jt.create_tasks(**kw), tt.create_tasks(**kw))


def test_cli_losses_match_jax(runs):
    out, jout = runs["port"][1], runs["jax"][1]
    assert len(out["train_losses"]) == ARGS["n_epochs"]
    np.testing.assert_allclose(out["train_losses"], jout["train_losses"], rtol=1e-4)
    np.testing.assert_allclose(out["val_losses"], jout["val_losses"], rtol=1e-4)
    assert out["std_scale"] == pytest.approx(jout["std_scale"], rel=1e-4)
    assert out["best_val"] == pytest.approx(jout["best_val"], rel=1e-4)


def test_cli_metadata_matches_jax(runs):
    port = load_run(runs["port_dir"], device="cpu")["metadata"]
    with open(os.path.join(runs["jax_dir"], "metadata.json")) as f:
        want = json.load(f)
    for key in ("data_settings", "date_info", "convnp_kwargs", "epoch", "step"):
        assert port[key] == want[key], key
    model_cfg = dict(want["model_config"], compute_dtype="float32")
    assert port["model_config"] == model_cfg


def test_jax_load_run_serves_the_port_cli_run(runs):
    jrun = jload_run(runs["port_dir"])
    port = load_run(runs["port_dir"], device="cpu")
    for k, v in params_from_jax(jax.device_get(jrun["params"])).items():
        assert torch.equal(port["params"][k], v), k
    assert jrun["std_scale"] == port["std_scale"] != 1.0
    times = list(runs["port"][0].task_times()[[1, 5]])
    assert_same_task(jrun["task_loader"](times, seed_override=4),
                     port["task_loader"](times, seed_override=4))


def test_load_real_data_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(paths, "_DATA_PATHS", {"save_model": {"fpath": str(tmp_path)}})
    arg_path = _write_args(tmp_path / "args.yaml", dict(ARGS, synthetic=False))
    with pytest.raises(NotImplementedError, match="data/sources/stations.py") as e:
        cli.main(["-arg_path", arg_path, "--device", "cpu"])
    for name in ("era5", "wrf", "topography", "h5py"):
        assert name in str(e.value)
    assert os.listdir(tmp_path / "temperature" / "cli_run") == ["args.yaml"]


def test_cli_knobs_reach_the_model(tmp_path, monkeypatch):
    """tests/test_cli_and_plot.py's YAML surface: remat, remat_policy and
    top_kernel reach the stored model config."""
    monkeypatch.setattr(paths, "_DATA_PATHS", {"save_model": {"fpath": str(tmp_path)}})
    args = dict(ARGS, n_epochs=1, batch_size=4, likelihood="cnp", remat=True,
                remat_policy="acts", top_kernel=3, model_name="knobs")
    run_dir = cli.main(["-arg_path", _write_args(tmp_path / "a.yaml", args), "--device", "cpu"])
    with open(os.path.join(run_dir, "metadata.json")) as f:
        meta = json.load(f)
    assert meta["data_settings"]["variable"] == "temperature"
    mc = meta["model_config"]
    assert (mc["remat"], mc["remat_policy"], mc["top_kernel"]) == (True, "acts", 3)
    assert load_run(run_dir, device="cpu")["variable"] == "temperature"


def test_cli_runs_on_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(paths, "_DATA_PATHS", {"save_model": {"fpath": str(tmp_path)}})
    arg_path = _write_args(tmp_path / "args.yaml", ARGS)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would train on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-arg_path", arg_path])


_COERCIONS = [
    ("str2bool", v) for v in (True, False, "True", "false", "1", "0", "yes", "N", "maybe")
] + [
    (name, v) for name in ("int_or_none", "float_or_none", "str_or_none")
    for v in (None, "None", "null", "", "5", 7, "2.5")
] + [
    ("bool_or_float_or_str", v)
    for v in (True, False, 0.3, 2, "0.5", "true", "False", "random", "split", "all", "nope")
]


@pytest.mark.parametrize("name,value", _COERCIONS)
def test_converters_match_jax(name, value):
    def outcome(fn):
        try:
            return "ok", fn(value)
        except (ValueError, TypeError) as e:
            return type(e).__name__, str(e)
    got, want = outcome(getattr(utils, name)), outcome(getattr(jutils, name))
    assert got == want and type(got[1]) is type(want[1])


_ARG_DICTS = [
    {"variable": "temperature", "n_epochs": "3", "station_as_context": "0.3",
     "unet_channels": [8, 8], "include_landmask": "true"},
    {"init_lengthscale": "0.00714", "lengthscale_lr_mult": "100"},
    {"init_lengthscale": {"ls_decoder": "0.02", "ls_points_0": 0.01}, "remat": "yes",
     "remat_policy": "acts", "remove_stations": None, "context_variables": ["humidity"]},
    {"synthetic": True, "start_init": "20200101", "time_intervals": "3", "profile": "tuned"},
]


@pytest.mark.parametrize("args", _ARG_DICTS)
def test_validate_and_convert_args_matches_jax(args):
    assert utils.validate_and_convert_args(dict(args)) \
        == jutils.validate_and_convert_args(dict(args))


def test_unknown_argument_raises_as_jax():
    assert set(utils.ARG_SCHEMA) == set(jutils.ARG_SCHEMA)
    with pytest.raises(KeyError) as e:
        utils.validate_and_convert_args({"not_a_real_arg": 1})
    with pytest.raises(KeyError) as je:
        jutils.validate_and_convert_args({"not_a_real_arg": 1})
    assert str(e.value) == str(je.value)


_PROFILE_CASES = [
    {"variable": "temperature", "profile": "tuned"},
    {"variable": "precipitation", "profile": "tuned"},
    {"variable": "temperature", "profile": "tuned", "internal_density": 500},
    {"variable": "surface_pressure"},
    {"variable": "surface_pressure", "profile": "parity"},
    {"variable": "precipitation", "profile": "tuned", "internal_density": 24},
    {"variable": "precipitation", "profile": "tuned", "internal_density": 24,
     "init_lengthscale": 0.03},
    {"variable": "temperature", "profile": "tuned", "init_lengthscale": 0.0012},
    {"variable": "precipitation", "profile": "tuned", "init_lengthscale": 0.005,
     "internal_density": 100},
    {"variable": "temperature", "profile": "throughput"},
    {"variable": "10m_u_component_of_wind", "profile": "throughput"},
    {"variable": "humidity", "profile": "throughput", "init_lengthscale": {}},
    {"variable": "temperature", "profile": "throughput",
     "init_lengthscale": {"ls_decoder": 0.001}},
]


@pytest.mark.parametrize("args", _PROFILE_CASES)
def test_apply_profile_matches_jax(args):
    def outcome(mod, apply_profile):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out = apply_profile(mod.validate_and_convert_args(dict(args)))
        return out, [(x.category, str(x.message)) for x in w]
    got, want = outcome(utils, cfg.apply_profile), outcome(jutils, jcfg.apply_profile)
    assert got == want


def test_profiles_match_jax():
    assert cfg.PROFILES == jcfg.PROFILES
    assert cfg.TUNED_PROFILE == jcfg.TUNED_PROFILE
    assert cfg.THROUGHPUT_PROFILE == jcfg.THROUGHPUT_PROFILE
    for ls in (0.01, 3, {"ls_decoder": 0.02, "ls_grid_0": 0.5}, [("ls_decoder", 0.1)]):
        assert cfg.lengthscale_values(ls) == jcfg.lengthscale_values(ls)
    for mod in (cfg, jcfg):
        with pytest.raises(ValueError, match="unknown profile 'bogus'"):
            mod.apply_profile({"variable": "temperature", "profile": "bogus"})


@pytest.mark.parametrize("mod", [paths, jpaths], ids=["port", "jax"])
def test_data_paths_priority(mod, tmp_path, monkeypatch):
    """set_data_paths, then $DEEPSENSORNZ_PATHS, then ./data_paths.yaml /
    .yml / .json; none of them: the same FileNotFoundError."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(mod, "_DATA_PATHS", None)
    monkeypatch.delenv("DEEPSENSORNZ_PATHS", raising=False)
    with pytest.raises(FileNotFoundError) as e:
        mod.get_data_paths()
    assert "set_data_paths()" in str(e.value)
    (tmp_path / "data_paths.json").write_text(json.dumps({"cache": "json"}))
    assert mod.get_data_paths() == {"cache": "json"}
    monkeypatch.setattr(mod, "_DATA_PATHS", None)
    (tmp_path / "data_paths.yaml").write_text("cache: yaml\n")
    assert mod.get_data_paths() == {"cache": "yaml"}
    monkeypatch.setattr(mod, "_DATA_PATHS", None)
    env = tmp_path / "env.json"
    env.write_text(json.dumps({"cache": "env"}))
    monkeypatch.setenv("DEEPSENSORNZ_PATHS", str(env))
    assert mod.get_data_paths() == {"cache": "env"}
    mod.set_data_paths({"cache": "explicit"})
    assert mod.get_data_paths() == {"cache": "explicit"}


def test_data_paths_error_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DEEPSENSORNZ_PATHS", raising=False)
    msgs = []
    for mod in (paths, jpaths):
        monkeypatch.setattr(mod, "_DATA_PATHS", None)
        with pytest.raises(FileNotFoundError) as e:
            mod.get_data_paths()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_rmse_reexport():
    a, b = np.array([1.0, 2.0, np.nan]), np.array([1.5, 2.0, 3.0])
    assert utils.rmse(a, b) == jutils.rmse(a, b)
