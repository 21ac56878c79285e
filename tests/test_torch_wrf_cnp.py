"""The WRF operational model (a ``cnp`` ConvNP on a target grid finer than
its internal grid) served by ``Predictor.predict_grid``, against the
benchmark's plain reference ``benchmark/reference/convnp_cnp.py``, at a
size a CPU test holds; the request's gridded spans and counters; and the
reference's imports.

Both sides compute the U-Net in float32 here, on the same inputs and
weights (made by the benchmark's generator from a seed), so what is left
between them is rounding: float32 summation orders in the SetConvs and
the head, and the int16 transfer, which both sides apply per task over
the land cells.
"""

import ast
import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import manifest  # noqa: E402
from benchmark.entries import common, serve_wrf  # noqa: E402
from benchmark.reference import convnp_cnp  # noqa: E402
from deepsensornz_tpu_torch.data.grid import Field  # noqa: E402
from deepsensornz_tpu_torch.data.processor import DataProcessor  # noqa: E402
from deepsensornz_tpu_torch.infer.predict import Predictor  # noqa: E402
from deepsensornz_tpu_torch.perf import spans  # noqa: E402

CPU = torch.device("cpu")
CELL = "serve-wrf.cnp-wrf-d500"
# every grid finer than the 32×32 internal grid of density 24: base and
# aux 40×36, aux at the targets 52×50, targets 48×44
TINY_MODEL = {"unet_channels": [8, 8], "internal_density": 24, "decoder_channels": 8,
              "mlp_hidden": 8, "compute_dtype": "float32"}
TINY_TRAFFIC = {"target_hw": [48, 44], "base_hw": [40, 36], "aux_hw": [40, 36],
                "highres_hw": [52, 50], "tasks_per_request": 5, "pool": 1}
# rounding only: a value on an int16 step's edge may land on the
# neighbouring step on the other side (one step, 1/65535 of a task map's
# range), plus float32 summation orders, well under that step
STEPS = 1.0


def tiny_cell(std_scale: float = 0.8) -> manifest.Cell:
    cell = copy.deepcopy(manifest.resolve(CELL, manifest.load_manifest(ROOT)))
    cell.config["model"].update(TINY_MODEL)
    cell.traffic.update(TINY_TRAFFIC)
    cell.traffic["predictor"] = dict(cell.traffic["predictor"], std_scale=std_scale)
    return cell


def port_request(cell, seed: int, **predictor_kw):
    """(inputs, weights, the port's Prediction) of one request of the
    cell's first cycle on the CPU, set as the benchmark sets it."""
    dom, pool, weights = serve_wrf.serve_inputs(cell, seed, CPU)
    model = common.port_model(cell, weights, CPU).eval()
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
                          download_threads=pr["download_threads"])
    pred = predictor.predict_grid(common.task_batch(pool[0], dom, with_targets=False), dem,
                                  aux_at_targets=highres)
    return dom, pool, weights, pred


def _step(maps: np.ndarray) -> np.ndarray:
    """Each task's int16 step over its land cells, (B, 1, 1)."""
    land = np.isfinite(maps)
    hi = np.where(land, maps, -np.inf).max((1, 2))
    lo = np.where(land, maps, np.inf).min((1, 2))
    return ((hi - lo) / 65535.0)[:, None, None]


@pytest.mark.parametrize("seed,std_scale,chunk", [(3, 0.8, 24), (2**31 + 11, 1.7, 2),
                                                  (40, 0.5, None)])
def test_predict_grid_matches_the_cnp_reference(seed, std_scale, chunk):
    cell = tiny_cell(std_scale)
    dom, pool, weights, pred = port_request(cell, seed, batch_chunk=chunk)
    tasks = np.arange(cell.traffic["tasks_per_request"])
    want = serve_wrf.reference_maps(cell, weights, dom, pool[0], tasks, CPU)
    land = dom.land
    assert land.any() and not land.all()
    for key in ("mean", "std"):
        got, ref = pred[key].data, want[key]
        assert got.shape == ref.shape == (len(tasks),) + land.shape
        # sea is NaN and land finite, on both sides
        assert np.isnan(got[:, ~land]).all() and np.isfinite(got[:, land]).all()
        assert np.isnan(ref[:, ~land]).all()
        tol = STEPS * _step(ref) + 1e-5 * np.nanmax(np.abs(ref))
        assert (np.abs(np.nan_to_num(got - ref)) <= tol).all(), key
    # the spread is rescaled: std is σ·std_scale, in °C (the std 5 °C normalisation)
    assert np.nanmin(pred["std"].data) > 0


def test_std_scale_multiplies_the_cnp_std():
    """σ·s on the port's path (through ``rescale_raw``'s inverse softplus)
    against the reference's product, for two scales of one request."""
    a = port_request(tiny_cell(1.0), 5)[3]
    b = port_request(tiny_cell(2.5), 5)[3]
    ratio = b["std"].data / a["std"].data
    land = np.isfinite(ratio)
    np.testing.assert_allclose(ratio[land], 2.5, rtol=1e-3)
    np.testing.assert_array_equal(a["mean"].data, b["mean"].data)


@pytest.mark.parametrize("rows,block", [(7, 2), (1, 5)])
def test_the_reference_in_row_and_task_blocks_is_the_whole_grid(rows, block):
    """The reference's blocking: target rows a block at a time, tasks a
    few at a time, against one block of everything (float32: the blocks
    change no sum, only the shapes the contractions run at)."""
    cell = tiny_cell()
    dom, pool, weights = serve_wrf.serve_inputs(cell, 9, CPU)
    cfg = cell.config
    args = (weights, cfg["model"], pool[0], dom, cfg["normalisation"], 0.8, CPU)
    whole = convnp_cnp.serve_maps(*args, block=64, rows=1 << 10)
    parts = convnp_cnp.serve_maps(*args, block=block, rows=rows)
    for key in ("mean", "std"):
        tol = STEPS * _step(whole[key]) + 1e-5 * np.nanmax(np.abs(whole[key]))
        assert (np.abs(np.nan_to_num(parts[key] - whole[key])) <= tol).all()


def test_the_cnp_param_spec_is_the_ports_state_dict():
    from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig

    cell = tiny_cell()
    m = cell.config["model"]
    port = ConvNP(ConvNPConfig.from_dict(m), [3, 4], [1], 1)
    spec = serve_wrf.spec_for(cell)
    assert list(port.state_dict()) == list(spec)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
        k: tuple(s) for k, (s, _) in spec.items()}


def _grid_task(B=2, Hc=(12, 10), Wc=(11, 9), C=(3, 4), N=6):
    from deepsensornz_tpu_torch.task.task import GridContext, PointContext, TaskBatch

    g = torch.Generator().manual_seed(0)
    grids = tuple(GridContext(torch.linspace(0, 1, h), torch.linspace(0, 1, w),
                              torch.randn(B, h, w, c, generator=g))
                  for h, w, c in zip(Hc, Wc, C))
    pts = PointContext(torch.rand(B, N, 2, generator=g), torch.randn(B, N, 1, generator=g),
                       torch.ones(B, N))
    return TaskBatch(grids=grids, points=(pts,), xt=torch.rand(B, 3, 2, generator=g),
                     yt=torch.randn(B, 3, 1, generator=g), yt_mask=torch.ones(B, 3),
                     yt_aux=torch.randn(B, 3, 1, generator=g),
                     x1g=torch.linspace(-0.1, 1.1, 16), x2g=torch.linspace(-0.1, 1.1, 16))


@pytest.mark.parametrize("target_grid", [True, False])
def test_grid_spans_and_counters_record_only_inside_recording(target_grid):
    from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig

    task = _grid_task()
    model = ConvNP.from_task(ConvNPConfig(unet_channels=(4, 4), likelihood="cnp",
                                          internal_density=12, decoder_channels=4,
                                          mlp_hidden=4, compute_dtype="float32"), task)
    Ht, Wt = 7, 5
    grid = (torch.linspace(0, 1, Ht), torch.linspace(0, 1, Wt), torch.randn(2, Ht, Wt, 1))

    def call():
        with torch.no_grad():
            return model(task, target_grid=grid if target_grid else None)

    spans.clear()
    spans.reset("model.")
    outside = call()
    assert spans.records() == [] and spans.counters("model.") == {}
    with spans.recording():
        inside = call()
    torch.testing.assert_close(inside, outside, rtol=0, atol=0)
    names = [s.name for s in spans.records()]
    assert names.count("model.encode_grid") == 1
    assert names.count("model.decode_grid") == int(target_grid)
    want = {"model.encode_grid_cells": 2 * (12 * 11 * 4 + 10 * 9 * 5)}
    if target_grid:
        want["model.decode_grid_cells"] = 2 * Ht * Wt
    assert spans.counters("model.") == want
    snap = spans.snapshot()
    assert snap["model.encode_grid"]["total_s"] > 0
    spans.clear()
    spans.reset("model.")


REFERENCE = ROOT / "benchmark" / "reference"


def _top_level_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("name", ["convnp_cnp.py", "convnp.py"])
def test_the_reference_imports_no_jax_and_nothing_of_the_port(name):
    names = _top_level_imports(REFERENCE / name)
    assert names <= {"__future__", "math", "typing", "numpy", "torch"}, names


def test_the_reference_loads_no_jax_and_nothing_of_the_port():
    """Imported and run at a tiny size in a fresh interpreter."""
    code = ("import sys, numpy as np, torch\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from benchmark.reference import convnp_cnp\n"
            "raw = torch.randn(3, 2)\n"
            "mu, sd = convnp_cnp.mean_std(raw, 0.8)\n"
            "assert torch.equal(mu, raw[:, 0]) and bool((sd > 0).all())\n"
            "print(' '.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = {n.split(".")[0] for n in out.stdout.split()}
    assert not loaded & {"jax", "jaxlib", "flax", "optax", "deepsensornz_tpu",
                         "deepsensornz_tpu_torch"}
