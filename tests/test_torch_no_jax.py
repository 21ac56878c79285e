"""The port runs where JAX does not exist.

A machine with an NVIDIA card may have no jax, flax, pandas, msgpack or the
JAX package. These tests block those imports in a fresh interpreter, then
import every module of ``deepsensornz_tpu_torch`` and ``chip_smoke``, serve
a tiny gridded request on the CPU, serve it with samples, in chunks, at
points and by AR sampling, score every head (``sample``, ``cdf_bounds``,
``crps``), train (one train step and a one-epoch ``Trainer.fit`` with a
checkpoint), serve a run directory (a ``TaskLoader`` over
``StationFrame`` objects, the run written with ``params.pt`` and
``params.msgpack``, one ``PredictService.predict`` and one HTTP round
trip), train a run from data: synthetic data → preprocessing →
``Train.train_model`` → ``load_run`` → ``PredictService``, and validate
such a run: ``Validate``'s metrics with a holdout, ``ValidateERA`` from raw
fields and stations, and the quantised, chunked, threaded transfer, and
(with h5py blocked too) place stations by active learning, time it with the
perf harness, and train through the YAML CLI. The kernel module must also
import without ``nvcc``: the kernels are built at first use on the card.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_BLOCKED = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "deepsensornz_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
"""
# the card's machine has neither pandas nor msgpack either
_BLOCKED_ALL = _BLOCKED.replace('"deepsensornz_tpu")', '"deepsensornz_tpu", "pandas", "msgpack")')

_SERVE = _BLOCKED + """
import importlib, pkgutil
import numpy as np
import deepsensornz_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke as cs
from deepsensornz_tpu_torch.models.convnp import ConvNPConfig
from deepsensornz_tpu_torch.infer.predict import Predictor
from deepsensornz_tpu_torch.ops import setconv_cuda
dp = cs.make_processor("t")
dem, aux = cs.target_fields(dp, (20, 18), seed=0)
cfg = ConvNPConfig(unet_channels=(8, 8), internal_density=30, rank=4, decoder_channels=8,
                   mlp_hidden=8, compute_dtype="float32")
task = cs.cycle_task(0, 2, cfg.internal_density, base_hw=(9, 8), aux_hw=(20, 18), n_stations=12)
model = cs.build_model(cfg, task, seed=0, device="cpu")
setconv_cuda.reset_launch_counts()
pred = Predictor(model, dp, "t").predict_grid(task, dem, aux_at_targets=aux)
cs.check_prediction(pred, dem, 2)
assert setconv_cuda.launch_counts() == {"encode_offgrid": 0, "encode_offgrid_grad": 0,
                                        "decode_grid": 0}
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "deepsensornz_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("modules", len(names))
"""


def _run(code: str):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    # a PATH without the CUDA toolkit, as on a machine without nvcc
    env.update(PYTHONPATH=str(REPO), PATH="/usr/bin:/bin")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_and_serves_without_jax():
    proc = _run(_SERVE)
    assert proc.returncode == 0, proc.stderr
    assert "modules" in proc.stdout


def test_port_trains_without_jax(tmp_path):
    proc = _run(_BLOCKED + f"""
import math, os
import chip_smoke as cs
from deepsensornz_tpu_torch.models.convnp import ConvNPConfig
from deepsensornz_tpu_torch.task.batching import take
from deepsensornz_tpu_torch.train.checkpoint import load_checkpoint
from deepsensornz_tpu_torch.train.trainer import Trainer, init_state, make_train_step
cfg = ConvNPConfig(unet_channels=(8, 8), internal_density=30, rank=4, decoder_channels=8,
                   mlp_hidden=8, compute_dtype="float32")
tasks = cs.train_task(0, 5, cfg.internal_density, base_hw=(9, 8), aux_hw=(20, 18),
                      n_stations=12, n_targets=10)
model = cs.build_model(cfg, tasks, seed=0, device="cpu")
state, loss = make_train_step(model)(init_state(model), take(tasks, [0, 1]), 1e-3)
assert state.step == 1 and math.isfinite(float(loss))
out = Trainer(model, lr=1e-3).fit(tasks, take(tasks, [4]), n_epochs=1, batch_size=2,
                                  checkpoint_dir={str(tmp_path)!r}, verbose=False)
assert len(out["train_losses"]) == 1 and math.isfinite(out["best_val"])
ck = load_checkpoint({str(tmp_path)!r})
assert ck["metadata"]["epoch"] == 0 and ck["metadata"]["step"] == 3
assert sorted(os.listdir({str(tmp_path)!r})) == ["metadata.json", "opt_state.pt",
                                                 "params.msgpack", "params.pt"]
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("trained")
""")
    assert proc.returncode == 0, proc.stderr
    assert "trained" in proc.stdout


def test_port_samples_without_jax():
    proc = _run(_BLOCKED + """
import dataclasses
import numpy as np
import torch
import chip_smoke as cs
from deepsensornz_tpu_torch.infer.ar import ar_sample
from deepsensornz_tpu_torch.infer.predict import Predictor
from deepsensornz_tpu_torch.models import likelihoods as lik
from deepsensornz_tpu_torch.models.convnp import ConvNPConfig
dp = cs.make_processor("t")
dem, aux = cs.target_fields(dp, (20, 18), seed=0)
cfg = ConvNPConfig(unet_channels=(8, 8), internal_density=30, rank=4, decoder_channels=8,
                   mlp_hidden=8, compute_dtype="float32")
task = cs.train_task(0, 3, cfg.internal_density, base_hw=(9, 8), aux_hw=(20, 18),
                     n_stations=12, n_targets=10)
model = cs.build_model(cfg, task, seed=0, device="cpu")
sea = np.isnan(dem.data)
pred = Predictor(model, dp, "t", batch_chunk=2).predict_grid(task, dem, aux_at_targets=aux,
                                                             n_samples=2, seed=1)
cs.check_prediction(pred, dem, 3)
s = pred["samples"].data
assert s.shape == (2, 3, 20, 18) and np.isnan(s[..., sea]).all() and np.isfinite(s[..., ~sea]).all()
pts = Predictor(model, dp, "t").predict_points(task)
assert pts["mean"].shape == (3, 10) and np.isfinite(pts["mean"]).all()
ar = Predictor(model, dp, "t").ar_sample_grid(task, dem, aux_at_targets=aux, subsample_factor=4,
                                              n_blocks=3)
assert ar.shape == (1, 3, 20, 18) and np.isfinite(ar[..., ~sea]).all()
assert ar_sample(model, task, n_blocks=2).shape == (1, 3, 10, 1)
g = torch.Generator().manual_seed(0)
for name in ("gnp", "cnp", "bernoulli-gamma", "cnp-spikes-beta"):
    head = lik.get_likelihood(name)
    raw = torch.randn((2, 6, head.num_params()), generator=g)
    y = torch.rand((2, 6, 1), generator=g)
    assert head.sample(raw, g, 3).shape == (3, 2, 6, 1)
    lo, hi = head.cdf_bounds(raw, y)
    assert bool((lo <= hi).all()) and bool(torch.isfinite(head.crps(raw, y, g, 8)).all())
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "deepsensornz_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("sampled")
""")
    assert proc.returncode == 0, proc.stderr
    assert "sampled" in proc.stdout


def test_port_serves_a_run_directory_without_jax_pandas_or_msgpack(tmp_path):
    assert _BLOCKED_ALL != _BLOCKED
    proc = _run(_BLOCKED_ALL + f"""
import json, threading, urllib.request
from pathlib import Path
import numpy as np
import chip_smoke as cs
from deepsensornz_tpu_torch.infer.server import PredictService, serve
from deepsensornz_tpu_torch.models.convnp import ConvNPConfig
from deepsensornz_tpu_torch.pipeline.validate import load_run
from deepsensornz_tpu_torch.task.loader import TaskLoader
times, base, aux, highres, stations = cs.service_data(
    0, n_times=6, base_hw=(9, 8), aux_hw=(20, 18), highres_hw=(24, 22), n_stations=12)
tl = TaskLoader([base, aux, stations], stations, aux_at_targets=highres, internal_density=30)
cfg = ConvNPConfig(unet_channels=(8, 8), internal_density=30, rank=4, decoder_channels=8,
                   mlp_hidden=8, compute_dtype="float32")
model = cs.build_model(cfg, tl(list(times[:1])), seed=0, device="cpu")
dp = cs.make_processor("temperature_station")
run = Path({str(tmp_path)!r}) / "run"
cs.write_run(run, tl, dp, model)
assert sorted(p.name for p in run.iterdir()) == [
    "data_processor.json", "metadata.json", "params.msgpack", "params.pt", "task_loader.pkl"]
assert (load_run(str(run), device="cpu")["params"]["ls_decoder"] == model.ls_decoder).all()
(run / "params.pt").unlink()  # from here on the parameters come from params.msgpack
r = load_run(str(run), device="cpu")
for k, v in model.state_dict().items():
    assert (r["params"][k] == v).all(), k
dem, _ = cs.target_fields(dp, (40, 36), seed=0)
svc = PredictService(str(run), dem, highres_factor=2, device="cpu")
req = [str(t) for t in times[:3]]
resp = svc.predict(req)
mean = np.asarray(resp["mean"])
assert mean.shape == (3, 20, 18) and ((mean == -9999.0) == np.isnan(svc.pred_grid.data)).all()
assert svc.predictor.std_scale == cs.STD_SCALE
httpd = serve(str(run), dem, port=0, highres_factor=2, device="cpu")
thread = threading.Thread(target=httpd.serve_forever, daemon=True)
thread.start()
try:
    url = f"http://127.0.0.1:{{httpd.server_address[1]}}/predict"
    body = json.dumps({{"times": req}}).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=120) as r:
        assert r.status == 200 and json.loads(r.read()) == resp
finally:
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
assert not thread.is_alive()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "flax", "optax", "deepsensornz_tpu", "pandas", "msgpack") and sys.modules[m] is not None)
assert not leaked, leaked
print("served")
""")
    assert proc.returncode == 0, proc.stderr
    assert "served" in proc.stdout


def test_port_trains_a_run_from_data_without_jax_pandas_or_msgpack(tmp_path):
    """The pipeline at tests/test_pipeline.py's size; without pandas the
    loader is written in the port's layout, and says so."""
    proc = _run(_BLOCKED_ALL + f"""
import os
import numpy as np
from deepsensornz_tpu_torch.data.synthetic import synthetic_bundle
from deepsensornz_tpu_torch.infer.server import PredictService
from deepsensornz_tpu_torch.pipeline.preprocess import PreprocessForDownscaling
from deepsensornz_tpu_torch.pipeline.train import Train
from deepsensornz_tpu_torch.pipeline.validate import load_run
base, dem, stations = synthetic_bundle(n_times=10, base_hw=(24, 24), dem_hw=(96, 96),
                                       n_stations=20)
out = PreprocessForDownscaling("temperature").run_processing_sequence(
    dem, {{"temperature": base}}, stations, highres_factor=2, lowres_factor=4,
    include_landmask=True, include_time_of_year=True, include_coordinates=True, test_norm=True)
tr = Train(out, device="cpu")
tr.setup_task_loader(internal_density=24)
tr.initialise_model(unet_channels=(8, 8), likelihood="cnp", compute_dtype="float32",
                    decoder_channels=8, mlp_hidden=8)
run_dir = {str(tmp_path / "run")!r}
res = tr.train_model(n_epochs=2, batch_size=4, lr=1e-3, model_dir=run_dir, verbose=False)
assert np.isfinite(res["train_losses"]).all() and len(res["val_losses"]) == 2
assert sorted(os.listdir(run_dir)) == ["data_processor.json", "metadata.json", "opt_state.pt",
                                       "params.msgpack", "params.pt", "task_loader.pkl"]
data = open(os.path.join(run_dir, "task_loader.pkl"), "rb").read()
assert b"pandas" not in data and b"deepsensornz_tpu_torch.task.loader" in data
run = load_run(run_dir, device="cpu")
assert run["std_scale"] == res["std_scale"] != 1.0
svc = PredictService(run_dir, dem, highres_factor=2, device="cpu")
resp = svc.predict([str(t) for t in base.coords["time"][:2]])
mean = np.asarray(resp["mean"])
assert mean.shape == (2, 48, 48) and ((mean == -9999.0) == np.isnan(svc.pred_grid.data)).all()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "flax", "optax", "deepsensornz_tpu", "pandas", "msgpack") and sys.modules[m] is not None)
assert not leaked, leaked
print("pipeline")
""")
    assert proc.returncode == 0, proc.stderr
    assert "pipeline" in proc.stdout and "the port's TaskLoader layout" in proc.stdout


def test_port_validates_a_run_without_jax_pandas_or_msgpack(tmp_path):
    proc = _run(_BLOCKED_ALL + f"""
import numpy as np
from deepsensornz_tpu_torch.data.synthetic import synthetic_bundle
from deepsensornz_tpu_torch.pipeline.preprocess import PreprocessForDownscaling
from deepsensornz_tpu_torch.pipeline.train import Train
from deepsensornz_tpu_torch.pipeline.validate import Validate, ValidateERA
base, dem, stations = synthetic_bundle(n_times=8, base_hw=(16, 16), dem_hw=(48, 48),
                                       n_stations=16)
out = PreprocessForDownscaling("temperature").run_processing_sequence(
    dem, {{"temperature": base}}, stations, highres_factor=2, lowres_factor=4,
    include_time_of_year=True)
tr = Train(out, device="cpu")
tr.setup_task_loader(internal_density=24)
tr.initialise_model(unet_channels=(8, 8), likelihood="cnp", compute_dtype="float32",
                    decoder_channels=8, mlp_hidden=8)
run_dir = {str(tmp_path / "run")!r}
tr.train_model(n_epochs=1, batch_size=4, lr=1e-3, model_dir=run_dir, verbose=False)
v = Validate(run_dir, device="cpu")
times = list(base.coords["time"][:4])
held = [str(i) for i in np.unique(stations["station_id"])[:3]]
task = v._make_tasks(times, held)
assert task.points[0].mask.sum() < v._make_tasks(times).points[0].mask.sum()
loss = v.calculate_loss(times, held)
cal = v.calibration_stats(times, held)
pit = v.pit_stats(times, held)
crps = v.crps(times, held)
ext = v.extrapolation_loss(times, lat_range=(-90.0, float(np.median(stations["latitude"]))))
bands = v.elevation_band_errors(times, elevation_lookup=lambda la, lo: 100.0,
                                errors=loss["errors"], xt=loss["xt"])
sel = stations[np.isin(stations["time"], np.asarray(times, stations["time"].dtype))]
b = v.calculate_loss_base(base, sel)
ps = v.per_station_loss_base(base, stations, dates=times)
vals = [loss["rmse"], cal["z_std"], pit["z_std"], crps["crps"], ext["extrapolation"]["rmse"],
        b["rmse"], ps["mean_of_means"]]
assert np.isfinite(vals).all() and crps["crps"] > 0 and sum(map(len, bands["bands"].values()))
era = ValidateERA(run_dir, dem, highres_factor=2, transfer_dtype="int16", batch_chunk=2,
                  download_threads=3, upload_dtype="float16", device="cpu")
pred = era.predict(base.coords["time"][1:6], {{"temperature": base}}, station_df=sel,
                   remove_stations=held)
sea = np.isnan(era.pred_grid.data)
assert pred["mean"].shape == (5, 24, 24) and np.isfinite(pred["mean"].data[:, ~sea]).all()
assert set(era.predictor.last_timings) == {{"upload_s", "overlap_s"}}
empty = ValidateERA(run=era.run, pred_grid=era.pred_grid).predict(
    base.coords["time"][:2], {{"temperature": base}})
assert np.isnan(empty["std"].data[:, sea]).all() and (empty["std"].data[:, ~sea] > 0).all()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "flax", "optax", "deepsensornz_tpu", "pandas", "msgpack") and sys.modules[m] is not None)
assert not leaked, leaked
print("validated", vals)
""")
    assert proc.returncode == 0, proc.stderr
    assert "validated" in proc.stdout


def test_port_places_stations_and_trains_from_yaml_without_jax_pandas_msgpack_or_h5py(tmp_path):
    blocked = _BLOCKED_ALL.replace('"msgpack")', '"msgpack", "h5py")')
    assert "h5py" in blocked
    proc = _run(blocked + f"""
import numpy as np
import torch
import yaml
import chip_smoke as cs
from deepsensornz_tpu_torch import debug, paths, utils
from deepsensornz_tpu_torch.al import GreedyAlgorithm
from deepsensornz_tpu_torch.cli import train_downscaling
from deepsensornz_tpu_torch.models.convnp import ConvNPConfig
from deepsensornz_tpu_torch.perf import benchmark_fn, device_memory_stats
cfg = ConvNPConfig(unet_channels=(8, 8), internal_density=30, rank=4, decoder_channels=8,
                   mlp_hidden=8, compute_dtype="float32")
task = cs.train_task(0, 1, cfg.internal_density, base_hw=(9, 8), aux_hw=(20, 18),
                     n_stations=12, n_targets=10)
model = cs.build_model(cfg, task, seed=0, device="cpu")
rng = np.random.default_rng(0)
cand, aux = rng.random((6, 2)).astype(np.float32), rng.normal(size=(6, 1)).astype(np.float32)
alg = GreedyAlgorithm(model, mode="fast")
out = alg.run(task, cand, n_placements=1, candidate_aux=aux)
assert out["placements"].shape == (1, 2) and np.isfinite(out["acquisition_history"]).all()
assert any((out["placements"][0] == c).all() for c in cand)
timing = benchmark_fn(lambda: alg.run(task, cand, n_placements=1, candidate_aux=aux), reps=1)
assert timing["p50_s"] > 0 and device_memory_stats()[0]["bytes_in_use"] is None
debug.enable_debug(nans=True)
alg.run(task, cand, n_placements=1, candidate_aux=aux)  # finite throughout
debug.disable_debug()
paths.set_data_paths({{"save_model": {{"fpath": {str(tmp_path)!r}}}}})
args = {{"variable": "temperature", "model_name": "run", "synthetic": True, "n_epochs": 1,
        "batch_size": 8, "unet_channels": [8, 8], "likelihood": "gnp", "internal_density": 24,
        "highres_coarsen_factor": 2, "lowres_coarsen_factor": 4, "profile": "tuned"}}
arg_path = {str(tmp_path / "args.yaml")!r}
with open(arg_path, "w") as f:
    yaml.safe_dump(args, f)
run_dir = train_downscaling.main(["-arg_path", arg_path, "--device", "cpu"])
assert sorted(__import__("os").listdir(run_dir)) == [
    "args.yaml", "data_processor.json", "metadata.json", "opt_state.pt", "params.msgpack",
    "params.pt", "task_loader.pkl"]
assert utils.validate_and_convert_args({{"n_epochs": "2"}}) == {{"n_epochs": 2}}
leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "flax", "optax", "deepsensornz_tpu", "pandas", "msgpack", "h5py")
    and sys.modules[m] is not None)
assert not leaked, leaked
print("placed and trained", run_dir)
""")
    assert proc.returncode == 0, proc.stderr
    assert "placed and trained" in proc.stdout


def test_kernel_module_imports_without_nvcc():
    proc = _run(_BLOCKED + """
import shutil
assert shutil.which("nvcc") is None
from deepsensornz_tpu_torch.ops import setconv_cuda, _build
assert setconv_cuda.launch_counts() == {"encode_offgrid": 0, "encode_offgrid_grad": 0,
                                        "decode_grid": 0}
try:
    _build.find_nvcc()
except RuntimeError:
    print("no nvcc")
""")
    assert proc.returncode == 0, proc.stderr
    assert "no nvcc" in proc.stdout or Path("/usr/local/cuda/bin/nvcc").exists()


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """Without CUDA (and alone, without the port) chip_smoke fails and
    prints no result."""
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                              text=True, timeout=300,
                              env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
