"""The port's ``load_run``, ``PredictService`` and HTTP server against the
JAX package's, from a run directory the JAX package trained and wrote.

The run (as ``tests/test_server.py`` makes it): synthetic NZ-like data →
``PreprocessForDownscaling`` → ``Train`` (cnp head, float32, one epoch) →
``train_model(model_dir=...)``, which writes ``task_loader.pkl`` (the JAX
loader, holding pandas DataFrames), ``data_processor.json``,
``metadata.json`` (with a fitted ``std_scale``) and ``params.msgpack``.

The port reads that directory on the CPU and serves it; its responses must
match the JAX ``PredictService`` (both built with ``transfer_dtype=None``)
to rtol 1e-4 plus 1e-5 times the field's largest magnitude (float32
forwards in different summation orders), with identical sea cells,
coordinates and times. A run directory the port writes (``params.pt`` and
its own pickled loader) serves the same responses. The default service,
int16 like the JAX one (and so ``serve``), matches the JAX int16 service to
that tolerance plus one quantisation step of each map (its range / 65535):
the two sides' float32 maps may round to neighbouring steps.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deepsensornz_tpu.data.synthetic import synthetic_bundle
from deepsensornz_tpu.infer.server import PredictService as JPredictService
from deepsensornz_tpu.pipeline.preprocess import PreprocessForDownscaling
from deepsensornz_tpu.pipeline.train import Train
from deepsensornz_tpu_torch.data.grid import Field
from deepsensornz_tpu_torch.infer.server import PredictService, serve
from deepsensornz_tpu_torch.pipeline.validate import load_run
from deepsensornz_tpu_torch.task.loader import TaskLoader
from deepsensornz_tpu_torch.train.checkpoint import params_from_jax, save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    base, dem, stations = synthetic_bundle(n_times=6, base_hw=(16, 16), dem_hw=(32, 32),
                                           n_stations=10)
    out = PreprocessForDownscaling(variable="temperature").run_processing_sequence(
        dem, {"temperature": base}, stations, highres_factor=2, lowres_factor=4)
    tr = Train(out)
    tr.setup_task_loader(station_as_context="all", internal_density=24)
    tr.initialise_model(unet_channels=(8, 8), likelihood="cnp", compute_dtype="float32",
                        decoder_channels=8, mlp_hidden=8)
    model_dir = str(tmp_path_factory.mktemp("run") / "model")
    tr.train_model(n_epochs=1, batch_size=4, lr=1e-3, model_dir=model_dir, verbose=False)
    times = [str(t) for t in base.coords["time"][:3]]
    port_dem = Field(dem.data, dem.dims, dem.coords, dem.name, dict(dem.attrs))
    jsvc = JPredictService(model_dir, dem, highres_factor=2, transfer_dtype=None)
    return {"model_dir": model_dir, "dem": port_dem, "times": times, "jsvc": jsvc,
            "jresp": jsvc.predict(times),
            "jresp16": JPredictService(model_dir, dem, highres_factor=2).predict(times)}


def assert_response_matches(got: dict, want: dict, levels: int = 0):
    """``levels``: the responses were quantised to that many steps per map;
    one step more is let through."""
    assert set(got) == set(want)
    for key in ("variable", "times", "latitude", "longitude", "missing_value"):
        assert got[key] == want[key], key
    for key in ("mean", "std"):
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.shape == b.shape
        sea = b == want["missing_value"]
        np.testing.assert_array_equal(a == got["missing_value"], sea)
        assert (~sea).any()
        tol = 1e-4 * np.abs(b) + 1e-5 * float(np.abs(b[~sea]).max())
        if levels:
            land = np.where(sea, np.nan, b)
            tol = tol + (np.nanmax(land, axis=(1, 2), keepdims=True)
                         - np.nanmin(land, axis=(1, 2), keepdims=True)) / levels
        assert (np.abs(a - b)[~sea] <= tol[~sea]).all(), key


def test_load_run_reads_the_jax_directory(run):
    r = load_run(run["model_dir"], device="cpu")
    assert set(r) == {"model", "params", "task_loader", "data_processor", "metadata",
                      "variable", "std_scale"}
    assert isinstance(r["task_loader"], TaskLoader)
    assert r["variable"] == "temperature"
    assert r["std_scale"] == pytest.approx(run["jsvc"].run["std_scale"]) and r["std_scale"] != 1.0
    assert r["model"].cfg.likelihood == "cnp" and r["model"].cfg.unet_channels == (8, 8)
    assert not r["model"].training
    assert all(v.device.type == "cpu" for v in r["params"].values())
    # the flax params, converted, are the model's
    jparams = params_from_jax(jax.device_get(run["jsvc"].run["params"]))
    for k, v in jparams.items():
        assert torch.equal(r["params"][k], v), k


def test_predict_matches_jax_service(run):
    svc = PredictService(run["model_dir"], run["dem"], highres_factor=2, device="cpu")
    assert_response_matches(svc.predict(run["times"]), run["jresp"])
    one = svc.predict(run["times"][1:2])
    assert np.asarray(one["mean"]).shape == (1, 16, 16)
    assert_response_matches(one, run["jsvc"].predict(run["times"][1:2]))


def test_service_applies_shipped_recalibration(run):
    svc = PredictService(run["model_dir"], run["dem"], highres_factor=2, transfer_dtype=None,
                         device="cpu")
    assert svc.predictor.std_scale == pytest.approx(float(svc.run["std_scale"]))
    assert svc.run["std_scale"] != 1.0
    # without the factor the spread differs by it (cnp: std scales linearly)
    raw = svc.predictor.__class__(svc.run["model"], svc.run["data_processor"],
                                  svc.run["task_loader"].target_var_IDs)
    tl = svc.run["task_loader"]
    ts = np.asarray([np.datetime64(t) for t in run["times"]])
    a = svc.predictor.predict_grid(tl(list(ts), seed_override=42), svc.pred_grid,
                                   aux_at_targets=tl.aux_at_targets)
    b = raw.predict_grid(tl(list(ts), seed_override=42), svc.pred_grid,
                         aux_at_targets=tl.aux_at_targets)
    land = ~np.isnan(b["std"].data)
    np.testing.assert_allclose(a["std"].data[land], svc.run["std_scale"] * b["std"].data[land],
                               rtol=1e-5)


def test_port_written_run_serves_the_same(run, tmp_path):
    """The run re-written by the port (its pickled loader, ``params.pt``
    and also ``params.msgpack``) serves what the JAX directory serves."""
    src = load_run(run["model_dir"], device="cpu")
    port_dir = tmp_path / "port_run"
    port_dir.mkdir()
    with open(port_dir / "task_loader.pkl", "wb") as f:
        pickle.dump(src["task_loader"], f)
    assert b"pandas" not in (port_dir / "task_loader.pkl").read_bytes()
    shutil.copy(f"{run['model_dir']}/data_processor.json", port_dir)
    meta = {k: v for k, v in src["metadata"].items() if k != "step"}
    save_checkpoint(str(port_dir), src["params"], metadata=meta,
                    flax_upsample=src["model"].cfg.upsample)
    svc = PredictService(str(port_dir), run["dem"], highres_factor=2, transfer_dtype=None,
                         device="cpu")
    assert_response_matches(svc.predict(run["times"]), run["jresp"])
    (port_dir / "params.pt").unlink()  # now from params.msgpack
    again = load_run(str(port_dir), device="cpu")
    for k, v in src["params"].items():
        assert torch.equal(again["params"][k], v), k


def test_jax_pickle_without_pandas_says_so(run):
    """Without pandas, the JAX loader's pickle (it holds DataFrames) raises
    an error that names pandas; nothing is guessed."""
    code = f"""
import sys
sys.modules["pandas"] = None
from deepsensornz_tpu_torch.pipeline.validate import load_run
try:
    load_run({run["model_dir"]!r}, device="cpu")
except RuntimeError as e:
    print("refused:", e)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("refused:") and "pandas is not installed" in proc.stdout


def test_device_defaults_to_the_card(run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_run(run["model_dir"])
    with pytest.raises(RuntimeError, match="CUDA"):
        PredictService(run["model_dir"], run["dem"], highres_factor=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_run(run["model_dir"], device="cuda")


def test_int16_transfer_is_not_ported(run):
    """int16, once not ported, is the default now as in the JAX service:
    its responses match the JAX int16 service's."""
    svc = PredictService(run["model_dir"], run["dem"], highres_factor=2, device="cpu")
    p = svc.predictor
    assert (p.transfer_dtype, p.batch_chunk, p.download_threads) == ("int16", 24, 8)
    assert_response_matches(svc.predict(run["times"]), run["jresp16"], levels=65535)
    assert_response_matches(svc.predict(run["times"]), run["jresp"], levels=65535)


@pytest.fixture(scope="module")
def http(run):
    httpd = serve(run["model_dir"], run["dem"], port=0, highres_factor=2, device="cpu",
                  warmup_time=run["times"][0])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _post(url: str, body: bytes):
    return urllib.request.urlopen(urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"}), timeout=120)


def test_http_health(http):
    with urllib.request.urlopen(f"{http}/health", timeout=60) as r:
        assert json.loads(r.read()) == {"status": "ok", "variable": "temperature"}


def test_http_predict_matches_jax(http, run):
    with _post(f"{http}/predict", json.dumps({"times": run["times"]}).encode()) as r:
        assert r.status == 200 and r.headers["Content-Type"] == "application/json"
        body = json.loads(r.read())
    assert_response_matches(body, run["jresp16"], levels=65535)


@pytest.mark.parametrize("body", [b'{"nope": 1}', b'{"times": []}', b'{"times": "2000-01-01"}',
                                  b"not json", b'{"times": ["not a time"]}'], ids=str)
def test_http_bad_request(http, body):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{http}/predict", body)
    assert e.value.code == 400
    assert "error" in json.loads(e.value.read())


def test_http_unknown_endpoints(http):
    for req in (f"{http}/nope", urllib.request.Request(f"{http}/other", data=b"{}")):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 404
