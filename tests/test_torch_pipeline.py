"""The port's training pipeline from data against the JAX package's, on the CPU.

One trained run per side, at ``tests/test_pipeline.py``'s size: synthetic
data (10 daily times, 24² base, 96² DEM, 20 stations) →
``PreprocessForDownscaling`` (highres 2, lowres 4, landmask, time of year,
coordinate channels) → ``Train.setup_task_loader(internal_density=24)`` →
``initialise_model`` (cnp head, U-Net (8, 8), float32) → two epochs of
``train_model(model_dir=...)`` (batch 4, lr 1e-3), the port starting from
the JAX initial parameters (``params_from_jax``). Then the run directory
the port wrote is served by the JAX package (``load_run``), which is the
round trip a run trained on the card takes back to the JAX package.

Tolerances: tasks bit for bit; losses rtol 1e-4 (as
``tests/test_torch_train.py`` holds ``Trainer.fit``: float32 forwards and
backwards in different summation orders over four Adam steps);
``std_scale`` rtol 1e-4 (a std of float32 residual ratios, or a 30-step
bisection whose comparisons sit on such values); the served mean/std
rtol 1e-5 with an atol of 1e-5 times the field's largest magnitude (as
``tests/test_torch_predict.py``).
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from deepsensornz_tpu.data.synthetic import synthetic_base_grid as jsynthetic_base_grid
from deepsensornz_tpu.data.synthetic import synthetic_bundle as jsynthetic_bundle
from deepsensornz_tpu.data.synthetic import synthetic_dem as jsynthetic_dem
from deepsensornz_tpu.data.synthetic import synthetic_stations as jsynthetic_stations
from deepsensornz_tpu.infer.predict import Predictor as JPredictor
from deepsensornz_tpu.models.convnp import ConvNP as JConvNP
from deepsensornz_tpu.models.convnp import ConvNPConfig as JConfig
from deepsensornz_tpu.models.convnp import count_params as jcount_params
from deepsensornz_tpu.pipeline.preprocess import PreprocessForDownscaling as JPreprocess
from deepsensornz_tpu.pipeline.train import Train as JTrain
from deepsensornz_tpu.pipeline.train import fit_std_scale as jfit_std_scale
from deepsensornz_tpu.pipeline.validate import load_run as jload_run
from deepsensornz_tpu.task.loader import TaskLoader as JTaskLoader
from deepsensornz_tpu_torch.data.frame import StationFrame
from deepsensornz_tpu_torch.data.grid import Field
from deepsensornz_tpu_torch.data.synthetic import synthetic_bundle
from deepsensornz_tpu_torch.infer.predict import Predictor
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig, count_params
from deepsensornz_tpu_torch.pipeline.preprocess import PreprocessForDownscaling
from deepsensornz_tpu_torch.pipeline.train import Train, fit_std_scale
from deepsensornz_tpu_torch.pipeline.validate import load_run, load_task_loader, save_task_loader
from deepsensornz_tpu_torch.task.loader import TaskLoader
from deepsensornz_tpu_torch.task.task import TaskBatch
from deepsensornz_tpu_torch.train.checkpoint import params_from_jax

SIZE = dict(n_times=10, base_hw=(24, 24), dem_hw=(96, 96), n_stations=20)
SEQ = dict(highres_factor=2, lowres_factor=4, include_landmask=True, include_time_of_year=True,
           include_coordinates=True)
MODEL = dict(unet_channels=(8, 8), compute_dtype="float32", decoder_channels=8, mlp_hidden=8)
FIT = dict(n_epochs=2, batch_size=4, lr=1e-3, verbose=False)


def _bundles(variable: str):
    jb, jd, js = jsynthetic_bundle(variable, **SIZE)
    b, d, s = synthetic_bundle(variable, **SIZE)
    jout = JPreprocess(variable).run_processing_sequence(jd, {variable: jb}, js, **SEQ)
    out = PreprocessForDownscaling(variable).run_processing_sequence(d, {variable: b}, s, **SEQ)
    return out, jout, d


def _trains(variable: str, likelihood: str):
    out, jout, dem = _bundles(variable)
    jt = JTrain(jout)
    jt.setup_task_loader(internal_density=24)
    jt.initialise_model(likelihood=likelihood, **MODEL)
    tt = Train(out, device="cpu")
    tt.setup_task_loader(internal_density=24)
    tt.initialise_model(likelihood=likelihood, **MODEL)
    tt.params = params_from_jax(jax.device_get(jt.params), tt.model.cfg.upsample)
    return tt, jt, dem


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tt, jt, dem = _trains("temperature", "cnp")
    root = tmp_path_factory.mktemp("pipeline")
    port_dir, jax_dir = str(root / "port"), str(root / "jax")
    init = {k: v.clone() for k, v in tt.params.items()}
    jout = jt.train_model(model_dir=jax_dir, **FIT)
    out = tt.train_model(model_dir=port_dir, **FIT)
    return {"port": tt, "jax": jt, "out": out, "jout": jout, "port_dir": port_dir,
            "jax_dir": jax_dir, "dem": dem, "init": init}


def leaves(task):
    out = [("xt", task.xt), ("yt", task.yt), ("yt_mask", task.yt_mask),
           ("yt_aux", task.yt_aux), ("x1g", task.x1g), ("x2g", task.x2g)]
    for i, g in enumerate(task.grids):
        out += [(f"grid{i}.{k}", getattr(g, k)) for k in ("x1", "x2", "y", "mask")]
    for i, p in enumerate(task.points):
        out += [(f"points{i}.{k}", getattr(p, k)) for k in ("x", "y", "mask")]
    return out


def assert_same_task(jtask, task):
    """Equal structure; every leaf the same dtype, shape and bytes (``jtask``
    a JAX task or another port task)."""
    assert (len(task.grids), len(task.points)) == (len(jtask.grids), len(jtask.points))
    for (name, a), (_, b) in zip(leaves(jtask), leaves(task)):
        if a is None:
            assert b is None, name
            continue
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy()
        assert (a.dtype, a.shape) == (b.dtype, b.shape), name
        assert a.tobytes() == b.tobytes(), name


def test_loader_tasks_match_jax(runs):
    tt, jt = runs["port"], runs["jax"]
    assert isinstance(tt.task_loader.target, StationFrame)
    assert tt.internal_density == jt.internal_density == 24
    times = tt.task_times()
    np.testing.assert_array_equal(times, jt.task_times())
    for kw in ({"datewise_deterministic": True}, {"seed_override": 3}):
        assert_same_task(jt.create_tasks(**kw), tt.create_tasks(**kw))
    # the auto-inferred density (from the finest gridded context) as well
    assert tt.setup_task_loader().internal_density == jt.setup_task_loader().internal_density
    assert_same_task(jt.create_tasks(times[:3]), tt.create_tasks(times[:3]))


def test_two_epochs_match_jax(runs):
    out, jout = runs["out"], runs["jout"]
    np.testing.assert_allclose(out["train_losses"], jout["train_losses"], rtol=1e-4)
    np.testing.assert_allclose(out["val_losses"], jout["val_losses"], rtol=1e-4)
    assert out["std_scale"] == pytest.approx(jout["std_scale"], rel=1e-4)
    assert out["std_scale"] != 1.0
    moved = [k for k, v in runs["port"].params.items() if not torch.equal(v, runs["init"][k])]
    assert moved and count_params(runs["port"].params) == jcount_params(runs["jax"].params)


def test_run_directory_matches_jax(runs):
    files = sorted(os.listdir(runs["port_dir"]))
    assert files == ["data_processor.json", "losses.png", "metadata.json", "opt_state.msgpack",
                     "opt_state.pt", "params.msgpack", "params.pt", "task_loader.pkl"]
    port, jax_run = load_run(runs["port_dir"], device="cpu"), load_run(runs["jax_dir"],
                                                                       device="cpu")
    meta, jmeta = port["metadata"], jax_run["metadata"]
    for key in ("data_settings", "date_info", "convnp_kwargs", "model_config", "epoch", "step"):
        assert meta[key] == jmeta[key], key
    assert meta["std_scale"] == pytest.approx(jmeta["std_scale"], rel=1e-4)
    assert port["data_processor"].to_dict() == jax_run["data_processor"].to_dict()
    for k, v in port["params"].items():
        np.testing.assert_allclose(v.numpy(), jax_run["params"][k].numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=k)


def test_jax_package_serves_the_port_run(runs):
    """Fault C1: the JAX ``load_run`` reads the directory the port's
    ``Train`` wrote; its loader is the JAX class over DataFrames and builds
    the port's tasks bit for bit; its model serves the port's fields."""
    with open(os.path.join(runs["port_dir"], "task_loader.pkl"), "rb") as f:
        raw = pickle.load(f)
    assert type(raw) is JTaskLoader and raw._flat_cache == {}
    jrun = jload_run(runs["port_dir"])
    tl = jrun["task_loader"]
    assert type(tl) is JTaskLoader and type(tl.target).__name__ == "DataFrame"
    port = load_run(runs["port_dir"], device="cpu")
    for k, v in params_from_jax(jax.device_get(jrun["params"])).items():
        assert torch.equal(port["params"][k], v), k
    assert jrun["std_scale"] == port["std_scale"] != 1.0
    times = list(runs["port"].task_times()[[2, 7]])
    for kw in ({"seed_override": 42}, {"datewise_deterministic": True}):
        assert_same_task(tl(times, **kw), port["task_loader"](times, **kw))
    # served: the JAX model on its loader's task, the port's on its own
    dem = runs["dem"]
    jdem = jsynthetic_bundle(**SIZE)[1]
    ts = np.asarray(times)
    want = JPredictor(jrun["model"], jrun["params"], jrun["data_processor"], tl.target_var_IDs,
                      std_scale=jrun["std_scale"]).predict_grid(
        tl(times, seed_override=42), jdem.coarsen(2), aux_at_targets=tl.aux_at_targets, times=ts)
    ptl = port["task_loader"]
    got = Predictor(port["model"], port["data_processor"], ptl.target_var_IDs,
                    std_scale=port["std_scale"]).predict_grid(
        ptl(times, seed_override=42), dem.coarsen(2), aux_at_targets=ptl.aux_at_targets, times=ts)
    for key in ("mean", "std"):
        a, b = got[key].data, np.asarray(want[key].data)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        assert np.isfinite(a).any()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * float(np.nanmax(np.abs(b))))


def test_port_reads_every_layout(runs, tmp_path):
    """``load_task_loader`` reads the JAX package's pickle, the JAX layout
    the port writes, and the port's own pickle, to one loader."""
    times = list(runs["port"].task_times()[:4])
    want = runs["port"].task_loader(times, seed_override=1)
    own = tmp_path / "own.pkl"
    with open(own, "wb") as f:
        pickle.dump(runs["port"].task_loader, f)
    assert b"pandas" not in own.read_bytes() and b"deepsensornz_tpu.task" not in own.read_bytes()
    paths = [os.path.join(runs["jax_dir"], "task_loader.pkl"),
             os.path.join(runs["port_dir"], "task_loader.pkl"), str(own)]
    for path in paths:
        tl = load_task_loader(path)
        assert isinstance(tl, TaskLoader) and isinstance(tl.target, StationFrame)
        assert tl.target.columns == runs["port"].task_loader.target.columns
        assert_same_task(want, tl(times, seed_override=1))
    # a round trip through the JAX layout changes nothing
    again = tmp_path / "again.pkl"
    save_task_loader(load_task_loader(paths[2]), str(again))
    assert again.read_bytes() == open(paths[1], "rb").read()


def test_without_pandas_the_port_layout_is_written(runs, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(__import__("sys").modules, "pandas", None)
    path = tmp_path / "task_loader.pkl"
    save_task_loader(runs["port"].task_loader, str(path))
    assert "the port's TaskLoader layout" in capsys.readouterr().out
    monkeypatch.undo()
    data = path.read_bytes()
    assert b"pandas" not in data and b"deepsensornz_tpu_torch.task.loader" in data
    times = list(runs["port"].task_times()[:2])
    assert_same_task(runs["port"].task_loader(times, seed_override=0),
                     load_task_loader(str(path))(times, seed_override=0))


@pytest.mark.parametrize("variable,likelihood,key,rtol,path", [
    ("temperature", "cnp", 1, 1e-4, "closed form"),
    ("temperature", "gnp", 1, 1e-4, "closed form"),
    ("precipitation", "bernoulli-gamma", 3, 5e-3, "bisection"),
    ("precipitation", "bernoulli-gamma", 2, 0.0, "clip"),
    ("humidity", "cnp-spikes-beta", 3, 5e-3, "bisection"),
    ("humidity", "cnp-spikes-beta", 0, 0.0, "clip")])
def test_fit_std_scale_matches_jax(variable, likelihood, key, rtol, path):
    """The same random-weight parameters (``jax.random.key(key)``) and the
    validation tasks of ten winter days (wet enough for the Gamma body):
    the Gaussian heads' closed form, and the mixed heads' PIT bisection,
    where it ends inside the clip and where the clip's end returns.
    Tolerance: rtol 1e-4 for the closed form; 5e-3 for the bisection, whose
    z_std(s) has a slope of about -1.1 at its root while the JAX package's
    float32 ``betainc`` (under jit) moves z_std by ~1.6e-3 (measured on the
    humidity case: its own unjitted z_std is 0.99842 at the JAX result and
    1.0000035 at the port's)."""
    jd = jsynthetic_dem(*SIZE["dem_hw"], seed=0)
    base = dict(n_times=SIZE["n_times"], n_lat=24, n_lon=24, start="2000-07-01", seed=1)
    jb = jsynthetic_base_grid(variable, **base)
    js = jsynthetic_stations(jb, jd, variable, SIZE["n_stations"], seed=2)
    jout = JPreprocess(variable).run_processing_sequence(jd, {variable: jb}, js, **SEQ)
    jt = JTrain(jout)
    tl = jt.setup_task_loader(internal_density=24)
    jtasks = tl(list(jt.task_times()), datewise_deterministic=True)
    jcfg = JConfig(likelihood=likelihood, internal_density=24, rank=4, **MODEL)
    jmodel = JConvNP(jcfg)
    jparams = jmodel.init(jax.random.key(key), jtasks)
    model = ConvNP.from_task(ConvNPConfig.from_dict(jcfg.__dict__), TaskBatch.from_numpy(jtasks))
    params = params_from_jax(jax.device_get(jparams), model.cfg.upsample)
    want = jfit_std_scale(jmodel, jparams, jtasks)
    got = fit_std_scale(model, params, TaskBatch.from_numpy(jtasks))
    assert got == pytest.approx(want, rel=rtol, abs=0.0)
    if path == "clip":
        assert got in (0.05, 20.0)
    else:
        assert 0.05 < got < 20.0 and got != 1.0


def test_train_defaults_to_the_card(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Train(runs["port"].p)
    assert isinstance(runs["port"].p["base_ds"]["t2m"], Field)
