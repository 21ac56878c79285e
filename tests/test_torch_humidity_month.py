"""The humidity model (a ``cnp-spikes-beta`` ConvNP) served as a year run
serves it, a month of hourly tasks a request in chunks, by
``Predictor.predict_grid``, against the benchmark's plain reference
``benchmark/reference/convnp_spikes_beta.py``, at a size a CPU test holds;
the entry ``serve_month`` of ``serve-month.spikesbeta-d500`` (its inputs,
checked tasks, numbers and a tiny run); and the reference's imports.

Both sides compute the U-Net in float32 here, on the same inputs and
weights (made by the benchmark's generator from a seed), and take the
value leaves rounded to float16 (the port by its ``upload_dtype``, the
reference by rounding them itself), so what is left between them is
rounding: float32 summation orders in the SetConvs, the head and the
moments, and the int16 transfer, which both sides apply per task over the
land cells.
"""

import ast
import copy
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import check, core, manifest  # noqa: E402
from benchmark.entries import common, serve_month  # noqa: E402
from benchmark.reference import convnp_spikes_beta as ref_sb  # noqa: E402
from deepsensornz_tpu_torch.data.grid import Field  # noqa: E402
from deepsensornz_tpu_torch.data.processor import DataProcessor  # noqa: E402
from deepsensornz_tpu_torch.infer.predict import Predictor  # noqa: E402
from deepsensornz_tpu_torch.perf import spans  # noqa: E402
from deepsensornz_tpu_torch.pipeline.validate import post_transform_for  # noqa: E402

CPU = torch.device("cpu")
CELL = "serve-month.spikesbeta-d500"
TINY_MODEL = {"unet_channels": [8, 8], "internal_density": 24, "decoder_channels": 8,
              "mlp_hidden": 8, "compute_dtype": "float32"}
TINY_TRAFFIC = {"target_hw": [30, 26], "base_hw": [10, 9], "aux_hw": [20, 18],
                "highres_hw": [40, 36], "tasks_per_request": 7, "pool": 1}
# rounding only: a value on an int16 step's edge may land on the
# neighbouring step on the other side (one step, 1/65535 of a task map's
# range), plus float32 summation orders, well under that step
STEPS = 1.0


def tiny_cell(std_scale: float = 0.8, tasks: int = 7, dtype: str = "float32") -> manifest.Cell:
    cell = copy.deepcopy(manifest.resolve(CELL, manifest.load_manifest(ROOT)))
    cell.config["model"].update(TINY_MODEL, compute_dtype=dtype)
    cell.traffic.update(TINY_TRAFFIC, tasks_per_request=tasks)
    cell.traffic["predictor"] = dict(cell.traffic["predictor"], std_scale=std_scale)
    return cell


@pytest.fixture(scope="module")
def served():
    """Inputs, weights and the port's model of the tiny cell's first month."""
    out = {}

    def get(seed: int, tasks: int = 7):
        if (seed, tasks) not in out:
            cell = tiny_cell(tasks=tasks)
            dom, pool, weights = serve_month.serve_inputs(cell, seed, CPU)
            out[seed, tasks] = (dom, pool, weights, common.port_model(cell, weights, CPU).eval())
        return out[seed, tasks]

    return get


def port_request(cell, dom, pool, model, post=True, **predictor_kw):
    """The port's Prediction of the cell's first month on the CPU, set as
    the benchmark sets it (``predictor_kw`` over the traffic's predictor)."""
    cfg, tr = cell.config, cell.traffic
    e = tr["extent"]
    dp = DataProcessor(x1_map=(e["minlat"], e["maxlat"]), x2_map=(e["minlon"], e["maxlon"]),
                       config={cfg["variable"]: cfg["normalisation"]})
    dem = Field(np.where(dom.land, 100.0, np.nan), ("latitude", "longitude"),
                {"latitude": dom.lat, "longitude": dom.lon}, "elevation")
    highres = Field(dom.highres, ("x1", "x2"), {"x1": dom.highres_x[0].astype(np.float64),
                                                "x2": dom.highres_x[1].astype(np.float64)},
                    "elevation")
    pr = dict(tr["predictor"], **predictor_kw)
    predictor = Predictor(model, dp, cfg["variable"], std_scale=pr["std_scale"],
                          transfer_dtype=pr["transfer_dtype"], batch_chunk=pr["batch_chunk"],
                          download_threads=pr["download_threads"],
                          upload_dtype=pr["upload_dtype"])
    return predictor.predict_grid(
        common.task_batch(pool[0], dom, with_targets=False), dem, aux_at_targets=highres,
        times=serve_month.hours(tr), post_transform=post_transform_for(pr["post_transform"])
        if post else None, outputs=tuple(pr["outputs"]))


def _step(maps: np.ndarray) -> np.ndarray:
    """Each task's int16 step over its land cells, (B, 1, 1)."""
    land = np.isfinite(maps)
    hi = np.where(land, maps, -np.inf).max((1, 2))
    lo = np.where(land, maps, np.inf).min((1, 2))
    return ((hi - lo) / 65535.0)[:, None, None]


@pytest.mark.parametrize("seed,std_scale,chunk,tasks,outputs", [
    (3, 0.8, 3, 7, ("mean",)),                   # 3 chunks, the tail padded
    (2**31 + 11, 1.7, 2, 6, ("mean", "std")),    # 3 whole chunks
    (40, 0.5, None, 5, ("mean", "std")),         # one chunk
    (7, 0.8, 24, 7, ("mean",)),                  # a batch shorter than its chunk
])
def test_predict_grid_matches_the_spikes_beta_reference(served, seed, std_scale, chunk, tasks,
                                                        outputs):
    cell = tiny_cell(std_scale, tasks)
    dom, pool, weights, model = served(seed, tasks)
    pred = port_request(cell, dom, pool, model, batch_chunk=chunk, outputs=list(outputs))
    want = serve_month.reference_maps(cell, weights, dom, pool[0], np.arange(tasks), CPU)
    land = dom.land
    assert land.any() and not land.all()
    assert set(pred) == set(outputs)
    for key in outputs:
        got, r = pred[key].data, want[key]
        assert got.shape == r.shape == (tasks,) + land.shape
        # sea is NaN and land finite, on both sides
        assert np.isnan(got[:, ~land]).all() and np.isfinite(got[:, land]).all()
        assert np.isnan(r[:, ~land]).all()
        tol = STEPS * _step(r) + 1e-5 * np.nanmax(np.abs(r))
        assert (np.abs(np.nan_to_num(got - r)) <= tol).all(), key
    # relative humidity: the mean is a fraction, the std positive
    assert 0.0 <= np.nanmin(pred["mean"].data) and np.nanmax(pred["mean"].data) <= 1.0
    if "std" in outputs:
        assert np.nanmin(pred["std"].data) > 0


@pytest.mark.parametrize("chunk,threads,outputs", [(3, 3, ("mean",)), (2, 1, ("mean", "std")),
                                                   (6, 8, ("mean",))])
def test_chunked_maps_are_bitwise_the_one_chunk_maps(served, chunk, threads, outputs):
    """Mean and std do not depend on the chunking (the int16 scales are
    per task) nor on the number of download threads: a 7-task request in
    chunks, the tail padded, is bit for bit the one-chunk request."""
    cell = tiny_cell()
    dom, pool, _, model = served(5)
    one = port_request(cell, dom, pool, model, batch_chunk=None, download_threads=1,
                       outputs=list(outputs))
    chunked = port_request(cell, dom, pool, model, batch_chunk=chunk, download_threads=threads,
                           outputs=list(outputs))
    for key in outputs:
        a, b = one[key].data, chunked[key].data
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=key)
    np.testing.assert_array_equal(chunked["mean"].coords["time"], serve_month.hours(cell.traffic))


def test_the_humidity_post_transform_is_the_shift_before_min_max(served):
    """With min 0 and max 1 the shift [0, 1] → [-1, 1] and the min_max
    unnormalisation compose to the identity: without the shift the maps
    read 0.5·y + 0.5 of those with it (float32 rounding of the two
    affine maps apart)."""
    cell = tiny_cell()
    dom, pool, _, model = served(5)
    kw = dict(outputs=["mean", "std"], batch_chunk=3)
    with_shift = port_request(cell, dom, pool, model, **kw)
    without = port_request(cell, dom, pool, model, post=False, **kw)
    land = dom.land
    np.testing.assert_allclose(without["mean"].data[:, land],
                               0.5 * with_shift["mean"].data[:, land] + 0.5, rtol=0, atol=1e-6)
    np.testing.assert_allclose(without["std"].data[:, land], 0.5 * with_shift["std"].data[:, land],
                               rtol=1e-6, atol=1e-7)
    back = ref_sb.to_model_space({k: with_shift[k].data for k in ("mean", "std")},
                                 cell.config["normalisation"])
    np.testing.assert_allclose(back["mean"][:, land], with_shift["mean"].data[:, land], atol=1e-7)


@pytest.mark.parametrize("s", [1.0, 0.8, 1.7])
def test_the_references_moments_are_the_mixtures(s):
    """Against the mixture's moments in float64 from scipy's Beta: spikes
    at 0 and 1 and a Beta(α/s², β/s²) body (float32 rounding)."""
    from scipy import stats

    raw = torch.randn(64, 5, generator=torch.Generator().manual_seed(0)) * 2.0
    mean, std = ref_sb.mean_std(raw, s)
    probs = torch.softmax(raw[:, :3].double(), -1).numpy()
    a = (torch.nn.functional.softplus(raw[:, 3].double()) + 1e-6).numpy() / s**2
    b = (torch.nn.functional.softplus(raw[:, 4].double()) + 1e-6).numpy() / s**2
    m_body, v_body = stats.beta.stats(a, b, moments="mv")
    m = probs[:, 1] + probs[:, 2] * m_body
    ex2 = probs[:, 1] + probs[:, 2] * (v_body + m_body**2)
    np.testing.assert_allclose(mean.numpy(), m, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(std.numpy(), np.sqrt(ex2 - m * m), rtol=1e-4, atol=1e-5)


def test_the_reference_rounds_the_value_leaves_to_float16_only():
    cell = tiny_cell()
    dom, pool, _ = serve_month.serve_inputs(cell, 2, CPU)
    sent = ref_sb.as_sent(pool[0])
    for k, v in pool[0].items():
        if k in ("base", "aux", "st_y", "st_mask"):
            np.testing.assert_array_equal(sent[k], v.astype(np.float16).astype(np.float32))
            assert k == "st_mask" or not np.array_equal(sent[k], v)
        else:
            assert sent[k] is v


def test_the_spikes_beta_param_spec_is_the_ports_state_dict():
    from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig

    cell = tiny_cell()
    port = ConvNP(ConvNPConfig.from_dict(cell.config["model"]), [3, 4], [1], 1)
    spec = serve_month.spec_for(cell)
    assert list(port.state_dict()) == list(spec)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
        k: tuple(s) for k, (s, _) in spec.items()}
    assert spec["head_out.bias"][0] == (5,)


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**40 + 17])
def test_the_checked_tasks_hold_the_first_and_the_last_chunk(seed):
    cell = copy.deepcopy(manifest.resolve(CELL, manifest.load_manifest(ROOT)))
    tr = cell.traffic
    B, C = tr["tasks_per_request"], tr["predictor"]["batch_chunk"]
    assert (B, C, B // C, B % C) == (744, 24, 31, 0)
    for request in range(5):
        idx = serve_month.checked_tasks(cell, seed, request)
        assert len(idx) == len(set(idx)) == tr["check_tasks"] == 4
        assert idx[0] < C and idx[-1] >= B - C and (np.diff(idx) > 0).all()
        assert np.array_equal(idx, serve_month.checked_tasks(cell, seed, request))
    assert not all(np.array_equal(serve_month.checked_tasks(cell, seed, 0),
                                  serve_month.checked_tasks(cell, seed, r)) for r in range(1, 5))
    # a request shorter than a chunk: every task, or check_tasks of them
    tr["tasks_per_request"] = 3
    assert list(serve_month.checked_tasks(cell, seed, 0)) == [0, 1, 2]


def test_the_months_values_are_humidity_in_model_space():
    cell = tiny_cell(tasks=48)
    dom, pool, _ = serve_month.serve_inputs(cell, 9, CPU)
    mo = pool[0]
    y = mo["base"][..., 0]
    assert 0.0 <= y.min() and y.max() <= 1.0 and not (y == 0).any()
    assert 0.06 < (y == 1.0).mean() < 0.10                   # share_at_1 0.08
    assert 0.75 < y[y < 1].mean() < 0.79                     # Beta(5, 1.5): 0.769
    st = mo["st_y"][..., 0][mo["st_mask"] > 0]
    assert 0.0 <= st.min() and st.max() <= 1.0
    # day-of-year channels follow each task's day: tasks 0-23 day 0, 24-47 day 1
    day = 2 * np.pi * np.array([0.0, 1.0]) / 365.0
    np.testing.assert_allclose(mo["base"][[0, 23, 24, 47], 0, 0, 1],
                               np.cos(day[[0, 0, 1, 1]]), rtol=1e-6)
    np.testing.assert_allclose(mo["base"][[0, 47], 0, 0, 2], np.sin(day), atol=1e-7)
    again = serve_month.month(9, 0, dom, cell.traffic, cell.config["values"])
    assert all(np.array_equal(again[k], mo[k]) for k in mo)


def test_the_numbers_catch_a_moved_mean_and_a_sea_cell():
    rng = np.random.default_rng(0)
    land = rng.random((3, 6, 5)) < 0.6
    mean = np.where(land, rng.random(land.shape), np.nan).astype(np.float32)
    std = np.where(land, 0.1 + rng.random(land.shape), np.nan).astype(np.float32)
    norm = {"method": "min_max", "params": {"min": 0.0, "max": 1.0}}
    want = [{"mean": mean, "std": std}]
    assert serve_month.numbers([{"mean": mean.copy()}], want, norm) == {
        "mean_err": 0.0, "sea_mismatch": 0.0}
    moved = serve_month.numbers([{"mean": mean + 0.01}], want, norm)
    expect = 0.01 * np.sqrt(land.sum()) / np.linalg.norm(std[land].astype(np.float64))
    assert moved["mean_err"] == pytest.approx(expect, rel=1e-3)
    wet = mean.copy()
    wet[~land] = 0.5
    assert serve_month.numbers([{"mean": wet}], want, norm)["sea_mismatch"] == (~land).sum()
    ok, _ = check.verdict(moved, {"mean_err": 3e-3, "sea_mismatch": 0})
    assert not ok


def test_the_fp8_control_is_not_correct():
    """The reference in the program's place, its U-Net in fp8, against the
    bfloat16 reference, at a tiny size: fails the cell's limits."""
    from benchmark import control_month

    cell = tiny_cell(dtype="bfloat16", tasks=5)
    cell.traffic["pool"] = 2
    ok, table = check.verdict(control_month.readings(cell, 2**31 + 3, CPU), cell.limits)
    assert not ok, table


def test_a_traced_tiny_month_run_is_correct_and_reports_the_drain(monkeypatch):
    """The entry at a tiny size on the CPU, 7 tasks in chunks of 3: correct,
    every per-layer metric of its line that the CPU can read, and one
    ``predict_grid.drain`` and 3 chunks a traced request."""
    cell = tiny_cell(tasks=7)
    cell.traffic.update(pool=2, warmup_requests=1, trace_requests=2, keep_share=1.0)
    cell.traffic["predictor"]["batch_chunk"] = 3
    spans.clear()
    spans.reset("predict_grid.chunks")
    result, lines = core.run_cell(cell, 2**31 + 77, 0.3, True, CPU, time.perf_counter())
    assert result["correct"], lines
    assert set(result["check"]) == {"mean_err", "sea_mismatch"}
    assert result["check"]["mean_err"]["value"] < 1e-4, lines
    m = result["metrics"]
    for name in ("request_drain_ms.serve", "request_maps_ms.serve", "request_wait_ms.serve"):
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms", name
    snap = spans.snapshot()
    assert snap["predict_grid.drain"]["count"] == snap["predict_grid"]["count"] == 2
    assert spans.counters("predict_grid.chunks") == {"predict_grid.chunks": 2 * 3}
    spans.clear()
    spans.reset("predict_grid.chunks")


REFERENCE = ROOT / "benchmark" / "reference" / "convnp_spikes_beta.py"


def test_the_spikes_beta_reference_imports_no_jax_and_nothing_of_the_port():
    names = set()
    for node in ast.walk(ast.parse(REFERENCE.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "typing", "numpy", "torch"}, names
    code = ("import sys, torch\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from benchmark.reference import convnp_spikes_beta as r\n"
            "mu, sd = r.mean_std(torch.randn(3, 5), 0.8)\n"
            "assert bool(((mu >= 0) & (mu <= 1) & (sd > 0)).all())\n"
            "print(' '.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = {n.split(".")[0] for n in out.stdout.split()}
    assert not loaded & {"jax", "jaxlib", "flax", "optax", "deepsensornz_tpu",
                         "deepsensornz_tpu_torch"}
