"""Drive the PyTorch/CUDA port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each; the first failure exits non-zero):

1. device  - require CUDA; print the card and ``nvidia-smi``'s name and
             power limit; set and print the TF32 switches (both off).
2. build   - compile the SetConv CUDA kernels (nvcc, sm_90a) from
             ``deepsensornz_tpu_torch/csrc``; print ptxas's registers and
             spills, and each kernel's HGMMA/HMMA count from
             ``cuobjdump -sass`` (fails if a kernel has none).
3. kernels - each kernel against its plain PyTorch version on the tensors
             the serving path feeds it: the 24x512 station set onto the
             608x608 internal grid (encode), the 24x608x608x64 bf16 U-Net
             output onto the 278x260 NZ 0.05 deg grid (decode), and the
             decode of f32 features at 4 tasks (the f32 / hoisted-head
             path); then the encode at the AR feedback shapes: 24 x
             (512 + 512) with the feedback half masked (``[ar]``'s chain)
             and 4 x (512 + 4552) with 4552 masked slots (AR on the 70x65
             subsampled grid, 8 blocks of 569). Median CUDA-event times of
             kernel and plain version, the work the inputs need (FLOPs over
             the nonzero RBF weights, bytes read and written once) and the
             least time the card could take for it (the larger of FLOPs at
             the TF32 tensor-core peak and bytes at the HBM rate); for the
             decode also the one PyTorch call that computes the same
             function (``einsum`` on the same f in f32, TF32 off).
4. serve   - the flagship ConvNP (U-Net (64,)*4, k=5, gnp rank 64, density
             500, bf16 U-Net, random weights from a seed) behind
             ``Predictor.predict_grid``: three requests of 24 tasks; checks
             the mean/std fields and that both kernels were launched.
5. service - serving from a run directory, as a user does: normalised
             x-space data (48 hourly times; a 139x130 3-channel base with a
             time axis, a 278x260 4-channel static aux, 512 stations with
             ~10 % of the rows missing as context and target, a 556x520
             1-channel aux at the targets) in the port's ``TaskLoader``
             (internal grid 608x608); the flagship ConvNP written as a run
             directory (pickled loader, processor, metadata with
             ``std_scale`` 0.8, ``params.pt`` and ``params.msgpack``, each
             loaded by ``load_run`` to the same tensors); then
             ``PredictService`` over a 2780x2600 DEM coarsened to 278x260:
             one warm-up and 3 timed ``predict`` calls of 24 times, each
             split into loader, ``predict_grid`` (wall and CUDA events) and
             response, each checked (B1 and B2 launched once, the native
             taskpack built the task, mean/std bitwise equal to a direct
             ``predict_grid`` on the loader's task, sea cells -9999); B1
             against its plain version on the loader's own task (24 x its
             point capacity, per-time padding, missing rows); then
             ``serve(port=0)`` on a thread: /health, one timed /predict of
             24 times, a bad request (400). Peak memory.
6. sample-serve - one 24-task request with 4 joint samples, twice with one
             seed: samples finite on land, NaN on sea, equal between the
             two, their per-cell mean within 4 std/sqrt(4) of the mean map
             on >= 99 % of land cells; then one 48-task request with
             ``batch_chunk=24`` whose mean/std match two 24-task requests.
             Wall and CUDA-event times, peak memory, launches.
7. ar      - ``ar_sample`` at ``perf/ar_bench.py``'s shape (24 tasks x 512
             targets, 8 blocks, one sample): one warm-up and 3 timed
             calls, B1 launched exactly 8 times per call; then one
             ``ar_sample_grid`` of 4 tasks on the 278x260 grid (subsample
             4, 8 blocks): shape, NaN sea, finite land, times.
8. reference - a small ConvNP on the GPU (kernels) against the same weights
             on the CPU (plain versions): ``predict_grid``,
             ``predict_points``, and the AR chain with the head's sample
             replaced by its mean over one visit order.
9. al      - greedy station placement (``GreedyAlgorithm``) with the
             flagship ConvNP at ``perf/al_bench.py``'s shape: one task, 512
             targets with one aux channel, 64 candidates with aux, 4
             placements. ``exhaustive`` then ``fast``, each timed with the
             port's ``benchmark_fn`` (1 warm-up, 3 reps) and once more with
             CUDA events; peak memory, B1/B2 launches (exhaustive 2 per
             placement, fast 1, B2 none), no plain SetConv on the card, the
             host synchronisations of a run and where they come from (none
             inside the rounds); placements distinct and drawn from the
             candidates, finite histories, the final task's ``Stddev`` not
             above the initial one's + 1e-6; B1 against its plain version at
             the exhaustive shape (64 x (512 + 4 + 1), 4 masked slots); one
             exhaustive run under ``profile_trace``: the five device ops
             that took most time, and the device's busy share.
10. al-reference - a small ConvNP's ``GreedyAlgorithm.run`` in both modes
             on the GPU (kernels) against the CPU (plain versions): each
             round's candidate scores within rtol 1e-4, each round decisive
             (the CPU's best ahead of its runner-up by more than twice the
             largest GPU-CPU score difference), the same placements,
             histories and final context set within rtol 1e-4.
11. train-kernels - B1's length-scale backward against its plain version in
             float64, at the training shape (8x512 stations onto 608x608),
             the serving shape (24x512) and a clustered layout (8x512, every
             station in one 0.2x0.2 corner: most tiles empty), for a random
             upstream gradient, a density-only one and one positive on
             every channel; twice each (the result must not change from run
             to run). At each shape: CUDA-event times of the wrapper and of
             the plain f32 autograd backward, the points the kernel keeps per
             32x32 tile (mean, largest, share of empty tiles), the share of
             cells some point reaches, the bound by the bytes those cells
             need and the kernel's share of it; at the training shape also
             the time torch would take to sum the partials (the kernel does
             it in its last block) and the kernel at l = 0.3, where every
             point reaches every tile.
12. train   - the flagship ConvNP's train step at ``perf/train_bench.py``'s
             shape (batch 8: the serving contexts plus 512 station targets
             with one aux channel; lr 5e-5): one warm-up step and 5 timed
             steps (CUDA events and wall, their median tasks/s), then one
             ``train_epoch`` over 5 batches timed as a whole (tasks over the
             window's wall time, synchronise to synchronise, host batching
             and uploads included); losses, peak memory; checks finite
             losses, moved parameters, and B1's forward and backward
             launched on every step; prints the strides B1's upstream
             gradient arrives with (a channel slice of the encodes'
             concatenation, read in place).
13. pipeline - a run trained from data and served, as a modeller does:
             the port's ``synthetic_bundle`` (temperature, 40 daily times, a
             139x130 base, a 2780x2600 DEM, 512 stations) ->
             ``PreprocessForDownscaling`` (highres x10, lowres x50, time of
             year) -> ``Train`` on the card -> ``setup_task_loader`` (density
             500: the 608x608 grid) -> the flagship ConvNP -> ``train_model``
             (2 epochs, batch 8: 32 training and 8 validation times,
             ``std_scale`` fitted, the run directory written) ->
             ``PredictService`` answering two 24-time requests. Wall time of
             each stage (generation, preprocessing, loader set-up, task
             building, each epoch, ``fit_std_scale``, the writes), the losses,
             ``std_scale``, peak memory, each request split as in [service],
             and the launches of training and of serving; checks finite
             losses, ``std_scale`` in [0.05, 20], B1, its l-gradient and B2
             launched and none of their plain versions called on the card,
             and each response bitwise equal to a direct ``predict_grid``.
             Outside the counted runs: B1 against its plain version on one
             training batch of the pipeline's loader (8 x its point
             capacity, ragged station sets in masked slots) with the
             trained model, and on the last request's 24-time task; B1's
             l-gradient on the same batch in float64 and timed as in
             [train-kernels].
14. validate - the pipeline's run directory validated, before it is
             removed: ``Validate(run_dir)`` and, on the 8 validation times
             with station ids 0-7 held out, ``calculate_loss``,
             ``elevation_band_errors`` (errors passed, DEM elevations),
             ``calibration_stats``, ``pit_stats``, ``crps``, then
             ``extrapolation_loss`` over a box of the southernmost tenth of
             stations and the two base-field baselines; then
             ``ValidateERA(run_dir, dem, highres_factor=10).predict`` of 24
             raw times twice, split normalise+swap / loader /
             ``predict_grid`` / rest. Wall and CUDA-event time of each call
             and its launches; checks finite metrics, z_std and PIT z_std in
             ``Z_STD_WINDOW``, 95 % coverages in ``COVERAGE_95_WINDOW``,
             CRPS > 0, the held-out stations absent from the context and
             present in the targets, B1 once per prediction and B2 once per
             ``ValidateERA`` request, no plain SetConv on the card, and
             ``ValidateERA`` bitwise equal to ``predict_grid`` on its task;
             B1 and B2 against their plain versions on those tasks. Then a
             72-time request in chunks of 24 for every ``transfer_dtype``
             (float32, float16, int16, int8) x ``download_threads`` (1, 8) x
             ``upload_dtype`` (float32, float16): wall and CUDA-event time,
             ``last_timings``, the largest error against float32 within
             the mode's bound, 8 threads bitwise equal to 1.
15. validate-reference - ``Validate`` on a small ConvNP of each head (gnp,
             cnp, bernoulli-gamma, cnp-spikes-beta) on the GPU and on the
             CPU from the same weights and run dict: ``calculate_loss``,
             ``calibration_stats``, ``pit_stats``, ``crps`` (the mixed
             heads on the same fixed samples, and once from the card's own
             generator), and ``wet_dry_skill`` for bernoulli-gamma.
16. train-reference - one train step of a small ConvNP on the GPU (kernels)
             and on the CPU (plain versions) from the same weights and
             batch: the loss, every parameter's gradient, and the update
             where Adam's first step is well conditioned.
17. cli-train - the YAML training CLI as a user runs it: a YAML
             (``synthetic: true``, the flagship's U-Net, gnp, density 500,
             2 epochs at batch 8) -> ``cli.train_downscaling.main`` into a
             temporary ``save_model`` root set with ``set_data_paths`` ->
             ``load_run`` -> one ``PredictService`` request. Each stage's
             wall time, losses, launches (B1, its l-gradient, B2), no plain
             SetConv on the card, the run's files and a bitwise response.

The first lines also say whether scipy (with its version), pandas, PyYAML
and matplotlib import. The last two lines are a JSON object of per-kernel
results (its launch counts are those of the main-path phases: serve,
service, sample-serve, ar, al, train, pipeline, validate and cli-train) and the
``{"ok": true, "device": {...}}`` line. Imports only the port, torch, numpy,
scipy and the standard library.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import importlib
import json
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
N_TASKS = 24
N_REQUESTS = 3
N_STATIONS = 512
F32_TASKS = 4  # depth of the f32-features decode check
TARGET_HW = (278, 260)  # NZ at 0.05 deg
TIMING_REPS = 5
# f32 agreement of a kernel with its plain version: the two sum in different
# orders, so |got - ref| <= RTOL*|ref| + ATOL_FRAC*max|ref|
RTOL = 1e-4
ATOL_FRAC = 1e-5
# the small GPU-vs-CPU forward also differs in the convs' summation order
REF_RTOL, REF_ATOL_FRAC = 1e-4, 1e-4
N_TRAIN_TASKS = 8  # perf/train_bench.py's batch
N_TARGETS = 512
TRAIN_LR = 5e-5
TRAIN_STEPS = 5  # timed, after one warm-up step
# B1's backward against its float64 plain version: dL/dl is one sum over
# every cell whose summands cancel, so its error is judged against both the
# value and the absolute sum of the summands, a few f32 roundings each:
# |got - ref| <= GRAD_RTOL * |ref| + GRAD_SUM_TOL * sum|terms|
GRAD_RTOL, GRAD_SUM_TOL = 1e-5, 1e-7
# the small train step on the GPU against the CPU, f32 on both with the
# summation orders of cuDNN and oneDNN (as tests/test_torch_train.py holds the
# port against JAX): the loss to rtol 1e-4; each gradient to rtol 1e-4 with
# an atol of 1e-4 times its largest magnitude. Adam's first step is
# g/(|g| + 1e-8) per element, so a gradient near 1e-8 that the tolerance
# lets differ moves its update by O(1). The update (p_new - p)/lr is held
# within 2e-3 where |g| >= 1e-6 and |g| >= 10x its tolerance: there the step
# moves by at most (1e-8/|g|)·(|dg|/|g|)/(1 - 0.1)^2 <= 1.3e-3.
TRAIN_REF_RTOL, TRAIN_REF_ATOL_FRAC, TRAIN_REF_STEP_ATOL = 1e-4, 1e-4, 2e-3
TRAIN_REF_STEP_MIN_GRAD = 1e-6

N_SAMPLES = 4  # joint samples of the sampled request
SAMPLE_SEED = 5
# the chunked request against unchunked ones: the same chunk size runs the
# same kernels in the same order, so only a rounding-level difference is let
# through: |got - ref| <= CHUNK_RTOL*|ref| + ATOL_FRAC*max|ref|
CHUNK_RTOL = 1e-5
AR_BLOCKS = 8
AR_REPS = 3  # timed ar_sample calls, after one warm-up
AR_GRID_TASKS = 4
AR_SUBSAMPLE = 4
AL_CANDIDATES = 64  # perf/al_bench.py's shape
AL_PLACEMENTS = 4
AL_REPS = 3  # timed runs of each mode, after one warm-up
# [al-reference]'s small model: 6 context stations, so that one placement
# moves the acquisition by more than the two devices' rounding
AL_REF_STATIONS, AL_REF_CANDIDATES, AL_REF_PLACEMENTS, AL_REF_SEED = 6, 8, 3, 11
AL_STDDEV_SLACK = 1e-6  # tests/test_ar_and_al.py's check
CLI_EPOCHS = 2
CLI_REQUEST_TIMES = 8
SERVICE_TIMES = 48  # hourly times in the service's data
SERVICE_REQUESTS = 3  # timed, after one warm-up
DEM_FACTOR = 10  # the 2780x2600 DEM coarsens to the 278x260 grid
HIGHRES_HW = (556, 520)  # the aux sampled at the targets
MISSING_ROWS = 0.1  # share of station rows absent
STD_SCALE = 0.8  # the run's recalibration factor
PIPELINE_TIMES = 40  # daily times of the pipeline's synthetic data
PIPELINE_DEM_HW = (2780, 2600)  # the raw DEM; x10 gives the 278x260 grid
PIPELINE_EPOCHS = 2
STD_SCALE_RANGE = (0.05, 20.0)  # fit_std_scale's clip
VALIDATE_TIMES = 8  # the pipeline's validation times
VALIDATE_HELD = 8  # station ids 0..7 leave the context
VALIDATE_BOX_QUANTILE = 0.1  # the extrapolation box: the southernmost tenth of stations
# wide sane windows for a run trained 2 epochs whose std_scale was fitted on
# these validation times: z_std (calibration and PIT) and 95 % coverage
Z_STD_WINDOW = (0.5, 2.0)
COVERAGE_95_WINDOW = (0.6, 1.0)
TRANSFER_TIMES = 72  # the transfer-mode request, in chunks of N_TASKS
# a float16 cast is at most half a unit in its last place off: 2^-11 of the
# normalised value (the physical value less the target's offset, or the std)
F16_HALF_ULP = 2.0 ** -11
# a float16 upload rounds every input to 2^-11 of itself; held loosely, at
# 2^-8 of the largest normalised value of the map
UPLOAD_F16_BOUND = 2.0 ** -8
# [validate-reference]: the small model's metrics on the GPU against the CPU
# (both torch f32): rtol 1e-4, coverages to 1/n; the mixed heads' PIT to
# 1e-3 (their CDFs, gammainc and the float64 betainc, in other orders)
VAL_REF_RTOL, VAL_REF_PIT_RTOL = 1e-4, 1e-3
# the least time the card could take: FLOPs at the dense TF32 tensor-core
# rate (the fastest the card multiplies f32 operands) or bytes at the HBM
# rate, whichever is larger (H100 SXM data sheet, at a 700 W limit)
PEAK_TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12

KERNELS = {
    "encode_offgrid": ("deepsensornz_tpu_torch/csrc/setconv_encode.cu",
                       "deepsensornz_tpu/ops/setconv_pallas.py:102"),
    # the l-gradient of the XLA encode the JAX trainer differentiates
    "encode_offgrid_grad": ("deepsensornz_tpu_torch/csrc/setconv_encode_grad.cu",
                            "deepsensornz_tpu/ops/setconv.py:42"),
    "decode_grid": ("deepsensornz_tpu_torch/csrc/setconv_decode.cu",
                    "deepsensornz_tpu/ops/setconv_pallas.py:204"),
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def module_version(name: str) -> str:
    """A module's version where it imports, else why not."""
    try:
        return getattr(importlib.import_module(name), "__version__", "imports")
    except ImportError as e:
        return f"does not import ({e})"


def import_port():
    """Import the port from this checkout, never from elsewhere."""
    sys.path.insert(0, str(REPO))
    import deepsensornz_tpu_torch

    where = Path(deepsensornz_tpu_torch.__file__).resolve().parent
    if where != REPO / "deepsensornz_tpu_torch":
        raise RuntimeError(f"deepsensornz_tpu_torch imported from {where}, not this checkout")
    return deepsensornz_tpu_torch


def compare(got, ref, rtol: float, atol_frac: float) -> dict:
    import torch

    got, ref = got.double(), ref.double()
    if got.shape != ref.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != reference {tuple(ref.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite values")
    err = (got - ref).abs()
    atol = atol_frac * float(ref.abs().max())
    worst = float((err - rtol * ref.abs() - atol).max())
    return {"max_abs_err": float(err.max()),
            "max_rel_err": float((err / (ref.abs() + atol + 1e-30)).max()),
            "atol": atol, "ok": worst <= 0.0}


def card_bound(flops: float, nbytes: float) -> dict:
    """The least time (ms) the card could take for this work, and which of
    the two terms sets it."""
    t_ops, t_bytes = flops / PEAK_TF32_FLOPS, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def reached_cells(setconv, x1g, x2g, x, mask, ls):
    """(B, H, W) bool: the cells where some point with mask != 0 has a
    nonzero RBF weight in both coordinates."""
    import torch

    rows = (setconv.rbf(x1g[None, :, None], x[:, None, :, 0], ls) != 0).float()  # (B, H, N)
    cols = ((setconv.rbf(x2g[None, None, :], x[:, :, None, 1], ls) != 0)
            & (mask != 0)[..., None]).float()                                    # (B, N, W)
    return torch.bmm(rows, cols) > 0


def encode_work(setconv, x1g, x2g, x, y, mask, ls, grad: bool = False) -> tuple[float, float]:
    """(FLOPs, bytes) the station encode needs on these inputs: 2(C+1)
    FLOPs for each grid cell where a point with mask != 0 has a nonzero RBF
    weight in both coordinates (everything else adds exact zeros); the
    inputs read once and the (B, H, W, C+1) output written once. Its
    l-gradient forms two such sums per channel and reads the upstream
    gradient and the forward's output instead of writing an output, over
    the reached cells only: every other cell's terms are exactly 0."""
    nh = (setconv.rbf(x1g[None, :, None], x[:, None, :, 0], ls) != 0).sum(1)  # (B, N)
    nw = (setconv.rbf(x2g[None, None, :], x[:, :, None, 1], ls) != 0).sum(2)  # (B, N)
    pairs = float((nh.double() * nw.double() * (mask != 0)).sum())
    c1 = y.shape[-1] + 1
    cells = x.shape[0] * x1g.shape[0] * x2g.shape[0] * c1
    inputs = 4 * (x.numel() + y.numel() + mask.numel() + x1g.numel() + x2g.numel())
    if grad:
        reached = float(reached_cells(setconv, x1g, x2g, x, mask, ls).sum()) * c1
        return 2 * 2.0 * c1 * pairs, inputs + 2 * 4 * reached + 4
    return 2.0 * c1 * pairs, inputs + 4 * cells


def decode_work(setconv, x1g, x2g, f, xt1, xt2, ls) -> tuple[float, float]:
    """(FLOPs, bytes) the gridded decode needs: the two separable products
    over the nonzero RBF weights only, in the cheaper order; f read once in
    its dtype, the f32 output written once."""
    nnz_a = float((setconv.rbf(xt1[:, None], x1g[None, :], ls) != 0).sum())  # (Ht, H)
    nnz_b = float((setconv.rbf(x2g[:, None], xt2[None, :], ls) != 0).sum())  # (W, Wt)
    B, H, W, C = f.shape
    Ht, Wt = xt1.shape[0], xt2.shape[0]
    flops = 2.0 * B * C * min(W * nnz_a + Ht * nnz_b, H * nnz_b + Wt * nnz_a)
    nbytes = (f.numel() * f.element_size() + 4 * B * Ht * Wt * C
              + 4 * (H + W + Ht + Wt))
    return flops, nbytes


def sass_tensor_ops(lib_path: Path) -> dict:
    """HGMMA/HMMA instruction counts per kernel in ``cuobjdump -sass`` of
    the built library: shows that the tensor cores are really used."""
    from deepsensornz_tpu_torch.ops._build import find_nvcc

    cuobjdump = str(Path(find_nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        fn = part.split(None, 1)[0]
        if "kernel" not in fn:
            continue
        counts[fn] = {op: sum(1 for line in part.splitlines()
                              if f" {op}." in line or f" {op} " in line)
                      for op in ("HGMMA", "HMMA")}
    return counts


def cuda_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def make_processor(target_var: str):
    from deepsensornz_tpu_torch.config import EXTENTS
    from deepsensornz_tpu_torch.data.processor import DataProcessor

    e = EXTENTS["all"]
    dp = DataProcessor()
    dp.set_coord_maps_from_extent(e["minlat"], e["maxlat"], e["minlon"], e["maxlon"])
    dp.config[target_var] = {"method": "mean_std", "params": {"mean": 12.0, "std": 5.0}}
    return dp


def target_fields(dp, hw: tuple, seed: int):
    """A synthetic NZ-extent DEM (NaN = sea) and the x-space aux Field."""
    from deepsensornz_tpu_torch.data.grid import Field

    rng = np.random.default_rng(seed)
    lat = np.linspace(dp.x1_map[0], dp.x1_map[1], hw[0])
    lon = np.linspace(dp.x2_map[0], dp.x2_map[1], hw[1])
    u, v = np.meshgrid(np.linspace(0, 1, hw[0]), np.linspace(0, 1, hw[1]), indexing="ij")
    elev = 800.0 * (np.sin(3.0 * u + 1.0) * np.cos(4.0 * v - 0.5) + 0.2)
    elev[elev < 0] = np.nan  # sea
    dem = Field(elev, ("latitude", "longitude"), {"latitude": lat, "longitude": lon}, "elevation")
    aux = Field(rng.normal(size=hw).astype(np.float32), ("x1", "x2"),
                {"x1": dp.map_x1(lat), "x2": dp.map_x2(lon)}, "elevation")
    return dem, aux


def cycle_task(seed: int, n_tasks: int, density: float, base_hw=(139, 130),
               aux_hw=TARGET_HW, n_stations: int = N_STATIONS):
    """Serving-cycle inputs: ERA5-scale base grid (3 channels), aux
    topography grid (4 channels), stations (1 channel), all in x-space."""
    import torch

    from deepsensornz_tpu_torch.ops.grids import internal_grid
    from deepsensornz_tpu_torch.task.task import GridContext, PointContext, TaskBatch

    rng = np.random.default_rng(seed)
    t = torch.from_numpy

    def lin(n):
        return t(np.linspace(0, 1, n).astype(np.float32))

    base_y = rng.normal(size=(n_tasks,) + tuple(base_hw) + (3,)).astype(np.float32)
    aux_y = np.repeat(rng.normal(size=(1,) + tuple(aux_hw) + (4,)).astype(np.float32), n_tasks, 0)
    st_x = np.repeat(rng.random((1, n_stations, 2)).astype(np.float32), n_tasks, 0)
    st_y = rng.normal(size=(n_tasks, n_stations, 1)).astype(np.float32)
    x1g, x2g = internal_grid((0.0, 1.0), (0.0, 1.0), density, 0.1, 16)
    return TaskBatch(
        grids=(GridContext(lin(base_hw[0]), lin(base_hw[1]), t(base_y)),
               GridContext(lin(aux_hw[0]), lin(aux_hw[1]), t(aux_y))),
        points=(PointContext(t(st_x), t(st_y), torch.ones(n_tasks, n_stations)),),
        xt=torch.zeros(n_tasks, 8, 2), yt=None, yt_mask=torch.ones(n_tasks, 8),
        yt_aux=torch.zeros(n_tasks, 8, 1), x1g=t(x1g), x2g=t(x2g))


def grad_task(n_tasks: int, density: float, corner: bool = False):
    """``[train-kernels]``'s inputs for B1's l-gradient: a serving cycle of
    ``n_tasks`` tasks, its stations uniform on the domain or, with
    ``corner``, all in one 0.2 x 0.2 corner (most cell tiles empty)."""
    from deepsensornz_tpu_torch.task.task import PointContext

    task = cycle_task(10 + n_tasks, n_tasks, density)
    if corner:
        p = task.points[0]
        task = dataclasses.replace(task, points=(PointContext(0.2 * p.x, p.y, p.mask),))
    return task


def train_task(seed: int, n_tasks: int, density: float, base_hw=(139, 130),
               aux_hw=TARGET_HW, n_stations: int = N_STATIONS, n_targets: int = N_TARGETS):
    """Training inputs (``perf/train_bench.py``'s shape): the serving
    cycle's context sets plus ``n_targets`` station targets per task, each
    with one aux channel."""
    import torch

    rng = np.random.default_rng(seed + 1000)
    t = torch.from_numpy
    task = cycle_task(seed, n_tasks, density, base_hw, aux_hw, n_stations)
    return dataclasses.replace(
        task, xt=t(rng.random((n_tasks, n_targets, 2)).astype(np.float32)),
        yt=t(rng.normal(size=(n_tasks, n_targets, 1)).astype(np.float32)),
        yt_mask=torch.ones(n_tasks, n_targets),
        yt_aux=t(rng.normal(size=(n_tasks, n_targets, 1)).astype(np.float32)))


def build_model(cfg, task, seed: int, device):
    import torch

    from deepsensornz_tpu_torch.models.convnp import ConvNP

    # parameters drawn on the CPU from a seeded generator, then moved
    g = torch.Generator().manual_seed(seed)
    return ConvNP.from_task(cfg, task, generator=g).to(device).eval()


def check_prediction(pred, dem, n_tasks: int) -> None:
    sea = np.isnan(dem.data)
    for key in ("mean", "std"):
        a = pred[key].data
        if a.shape != (n_tasks,) + dem.shape:
            raise AssertionError(f"{key} shape {a.shape}")
        if not np.isfinite(a[:, ~sea]).all():
            raise AssertionError(f"{key} not finite on land")
        if not np.isnan(a[:, sea]).all():
            raise AssertionError(f"{key} not NaN on sea")
    if not (pred["std"].data[:, ~sea] > 0).all():
        raise AssertionError("std not positive on land")


def timed(fn):
    """(result, CUDA-event ms, wall s) of one call, synchronise to synchronise."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), time.perf_counter() - t0


def service_data(seed: int, n_times: int = SERVICE_TIMES, base_hw=(139, 130),
                 aux_hw=TARGET_HW, highres_hw=HIGHRES_HW, n_stations: int = N_STATIONS,
                 target_var: str = "temperature_station"):
    """Normalised x-space data over [0, 1]^2 at ``n_times`` hourly times: a
    3-channel base Dataset with a time axis, a 4-channel static aux Dataset,
    a 1-channel highres aux Field and a StationFrame with ``MISSING_ROWS``
    of its rows absent. Returns (times, base, aux, highres, stations)."""
    from deepsensornz_tpu_torch.data.frame import StationFrame
    from deepsensornz_tpu_torch.data.grid import Dataset, Field

    rng = np.random.default_rng(seed)
    times = np.datetime64("2024-01-01T00:00:00") + np.arange(n_times) * np.timedelta64(1, "h")

    def grid(hw, name, with_time):
        shape = ((n_times,) if with_time else ()) + tuple(hw)
        coords = {"x1": np.linspace(0.0, 1.0, hw[0]), "x2": np.linspace(0.0, 1.0, hw[1])}
        dims = ("time", "x1", "x2") if with_time else ("x1", "x2")
        if with_time:
            coords["time"] = times
        return Field(rng.normal(size=shape).astype(np.float32), dims, coords, name)

    base = Dataset([grid(base_hw, f"base_{i}", True) for i in range(3)])
    aux = Dataset([grid(aux_hw, f"aux_{i}", False) for i in range(4)])
    highres = grid(highres_hw, "elevation", False)
    xy = rng.random((n_stations, 2))
    sid = np.tile(np.arange(n_stations), n_times)
    keep = rng.random(len(sid)) >= MISSING_ROWS
    sid = sid[keep]
    stations = StationFrame({
        "time": np.repeat(times, n_stations)[keep], "station_id": sid,
        "x1": xy[sid, 0], "x2": xy[sid, 1], target_var: rng.normal(size=len(sid))})
    return times, base, aux, highres, stations


def write_run(run_dir: Path, task_loader, dp, model, variable: str = "temperature") -> None:
    """A run directory in the JAX package's layout: the pickled loader,
    the processor, metadata (``model_config``, the variable, ``std_scale``)
    and the parameters as ``params.pt`` and ``params.msgpack``."""
    from deepsensornz_tpu_torch.train.checkpoint import save_checkpoint

    run_dir.mkdir(parents=True, exist_ok=True)
    with open(run_dir / "task_loader.pkl", "wb") as f:
        pickle.dump(task_loader, f)
    dp.save(str(run_dir / "data_processor.json"))
    mc = {k: (list(v) if isinstance(v, tuple) else v)
          for k, v in dataclasses.asdict(model.cfg).items() if k != "mesh_axes"}
    save_checkpoint(str(run_dir), model.state_dict(), flax_upsample=model.cfg.upsample,
                    metadata={"model_config": mc, "data_settings": {"variable": variable},
                              "std_scale": STD_SCALE})


class Timed:
    """A callable's stand-in that keeps each call's result, wall time and,
    with ``cuda_events``, CUDA-event time; other attributes pass through."""

    def __init__(self, fn, cuda_events: bool = False):
        self.fn, self.cuda_events, self.calls = fn, cuda_events, []

    def __call__(self, *args, **kwargs):
        import torch

        if self.cuda_events:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        wall = time.perf_counter() - t0
        ms = None
        if self.cuda_events:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        self.calls.append({"out": out, "wall_s": wall, "ms": ms})
        return out

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __get__(self, obj, objtype=None):
        """As a class attribute, a method: bound to the instance."""
        return self if obj is None else functools.partial(self, obj)


def service_phase(dev, cfg, dp, target_var, setconv_cuda, device=None) -> dict:
    """Phase 5: a run directory served by ``PredictService`` and ``serve``;
    returns the launch counts of the service's requests."""
    import torch

    from deepsensornz_tpu_torch.infer.server import PredictService, serve
    from deepsensornz_tpu_torch.native import taskpack
    from deepsensornz_tpu_torch.pipeline.validate import load_run
    from deepsensornz_tpu_torch.task.loader import TaskLoader

    if not taskpack.available():
        raise AssertionError(f"the native taskpack did not build: {taskpack.build_error()}")
    times, base, aux, highres, stations = service_data(50, target_var=target_var)
    tl = TaskLoader([base, aux, stations], stations, aux_at_targets=highres,
                    internal_density=cfg.internal_density)
    say("service", f"loader: {len(stations)} station rows over {len(times)} times, capacity "
        f"{tl.point_capacity}; internal grid {len(tl.x1g)}x{len(tl.x2g)}")
    if (len(tl.x1g), len(tl.x2g)) != (608, 608) and cfg.internal_density == 500:
        raise AssertionError("the loader's internal grid is not [serve]'s 608x608")
    model = build_model(cfg, tl(list(times[:1])), seed=7, device="cpu")
    dem, _ = target_fields(dp, (TARGET_HW[0] * DEM_FACTOR, TARGET_HW[1] * DEM_FACTOR), seed=2)
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = Path(tmp) / "run"
        t0 = time.perf_counter()
        write_run(run_dir, tl, dp, model)
        write_s = time.perf_counter() - t0
        msgpack_dir = Path(tmp) / "run_msgpack"
        shutil.copytree(run_dir, msgpack_dir, ignore=shutil.ignore_patterns("params.pt"))
        t0 = time.perf_counter()
        from_pt = load_run(str(run_dir), device=device)["params"]
        load_s = time.perf_counter() - t0
        from_msgpack = load_run(str(msgpack_dir), device=device)["params"]
        same = all(torch.equal(from_pt[k], from_msgpack[k]) and
                   torch.equal(from_pt[k].cpu(), v) for k, v in model.state_dict().items())
        sizes = {p.name: p.stat().st_size for p in run_dir.iterdir()}
        say("service", f"run directory written in {write_s:.3f} s ({sizes}); load_run "
            f"{load_s:.3f} s; params.pt and params.msgpack load to identical state_dicts: {same}")
        if not same or set(from_pt) != set(from_msgpack):
            raise AssertionError("load_run gave different parameters from params.pt and "
                                 "params.msgpack")
        del from_pt, from_msgpack

        svc = PredictService(str(run_dir), dem, highres_factor=DEM_FACTOR, device=device)
        loader = svc.run["task_loader"] = Timed(svc.run["task_loader"])
        forward = svc.predictor.predict_grid = Timed(svc.predictor.predict_grid,
                                                     cuda_events=True)
        sea = np.isnan(svc.pred_grid.data)
        if svc.pred_grid.shape != TARGET_HW or svc.predictor.std_scale != STD_SCALE:
            raise AssertionError(f"prediction grid {svc.pred_grid.shape}, std_scale "
                                 f"{svc.predictor.std_scale}")
        n = len(times)
        windows = [times[i: i + N_TASKS] for i in (0, n // 2, 0, n // 4)]  # warm-up, then timed
        totals = dict.fromkeys(setconv_cuda.launch_counts(), 0)
        responses, rows = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for i, window in enumerate(windows):
            req = [str(t) for t in window]
            setconv_cuda.reset_launch_counts()
            taskpack.reset_call_counts()
            t0 = time.perf_counter()
            resp = svc.predict(req)
            total_s = time.perf_counter() - t0
            launches, packed = setconv_cuda.launch_counts(), taskpack.call_counts()
            for k, v in launches.items():
                totals[k] += v
            task, fwd = loader.calls[-1]["out"], forward.calls[-1]
            direct = forward.fn(task, svc.pred_grid, aux_at_targets=loader.aux_at_targets,
                                times=np.asarray(window))
            checks = {}
            for key in ("mean", "std"):
                got = np.asarray(resp[key], np.float32)
                want = np.nan_to_num(direct[key].data, nan=-9999.0)
                checks[key] = (got.shape == (N_TASKS,) + TARGET_HW
                               and got.tobytes() == want.tobytes()
                               and bool(((got == -9999.0) == sea).all()))
            row = {"loader_s": loader.calls[-1]["wall_s"], "forward_s": fwd["wall_s"],
                   "forward_ms": fwd["ms"],
                   "response_s": total_s - loader.calls[-1]["wall_s"] - fwd["wall_s"],
                   "total_s": total_s}
            say("service", f"predict {i}{' (warm-up)' if i == 0 else ''} ({N_TASKS} times "
                f"from {req[0]}): {total_s:.3f} s wall = loader {row['loader_s']:.4f} s + "
                f"predict_grid {row['forward_s']:.4f} s ({row['forward_ms']:.1f} ms CUDA events) "
                f"+ response {row['response_s']:.4f} s; launches {launches}; native taskpack "
                f"calls {packed}; bitwise equal to a direct predict_grid with sea -9999: {checks}")
            if launches["encode_offgrid"] != 1 or launches["decode_grid"] != 1:
                raise AssertionError(f"request {i} launched {launches}, not B1 and B2 once")
            if packed != {"pack_station_batches": 2, "interp_grid_points": 1}:
                raise AssertionError(f"request {i}: the native taskpack did not build the task "
                                     f"({packed})")
            if not all(checks.values()):
                raise AssertionError(f"request {i}: the response differs from predict_grid")
            responses.append(resp)
            if i:
                rows.append(row)
        peak = torch.cuda.max_memory_allocated(dev)
        med = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
        say("service", f"median of {SERVICE_REQUESTS} requests: {med['total_s']:.3f} s wall = "
            f"loader {med['loader_s']:.4f} s + predict_grid {med['forward_s']:.4f} s "
            f"({med['forward_ms']:.1f} ms CUDA events) + response {med['response_s']:.4f} s; "
            f"peak memory {peak / 2**30:.2f} GiB")
        # outside the counted requests: B1 at the loader's own shape
        b1_err = encode_check(svc.predictor.model, loader.calls[1]["out"].to(dev))
        stack_timing(aux)

        httpd = serve(str(run_dir), dem, port=0, highres_factor=DEM_FACTOR, device=device)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            with urllib.request.urlopen(f"{url}/health", timeout=120) as r:
                health = json.loads(r.read())
            body = json.dumps({"times": responses[1]["times"]}).encode()
            setconv_cuda.reset_launch_counts()
            t0 = time.perf_counter()
            with urllib.request.urlopen(urllib.request.Request(
                    f"{url}/predict", data=body,
                    headers={"Content-Type": "application/json"}), timeout=600) as r:
                status, raw = r.status, r.read()
            http_s = time.perf_counter() - t0
            launches = setconv_cuda.launch_counts()
            for k, v in launches.items():
                totals[k] += v
            got = json.loads(raw)
            try:
                urllib.request.urlopen(urllib.request.Request(
                    f"{url}/predict", data=b'{"times": []}'), timeout=120)
                bad = 200
            except urllib.error.HTTPError as e:
                bad = e.code
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
        same = got == responses[1]
        say("service", f"HTTP: /health {health}; POST /predict ({N_TASKS} times) {status} in "
            f"{http_s:.3f} s wall ({len(raw) / 2**20:.1f} MiB of JSON), equal to the service's "
            f"response {same}; launches {launches}; bad request {bad}")
        if health != {"status": "ok", "variable": "temperature"} or status != 200 or not same:
            raise AssertionError("the HTTP round trip failed")
        if launches["encode_offgrid"] != 1 or launches["decode_grid"] != 1:
            raise AssertionError(f"the HTTP request launched {launches}, not B1 and B2 once")
        if bad != 400:
            raise AssertionError(f"a bad request got {bad}, not 400")
        if thread.is_alive():
            raise AssertionError("the HTTP server thread did not stop")
    say("service", f"launches {totals}")
    return totals, b1_err


def stack_timing(aux, reps: int = TIMING_REPS) -> None:
    """Host time of the loader's two ways to stack the static aux grid's
    channels, broadcast over a request's times, into a tensor: ``np.stack``
    (whose result from broadcast views is not C-contiguous, so the tensor
    needs a second copy) and ``_stack_channels``; medians of ``reps``."""
    import torch

    from deepsensornz_tpu_torch.task.loader import _grid_channels, _stack_channels

    chans = [np.broadcast_to(np.nan_to_num(f.data.astype(np.float32)), (N_TASKS,) + f.data.shape)
             for f in _grid_channels(aux)]
    ways = {"np.stack + ascontiguousarray":
            lambda: torch.from_numpy(np.ascontiguousarray(np.stack(chans, -1))),
            "_stack_channels": lambda: torch.from_numpy(_stack_channels(chans))}
    out, ms = {}, {}
    for name, fn in ways.items():
        times = []
        for _ in range(1 + reps):
            t0 = time.perf_counter()
            out[name] = fn()
            times.append(1e3 * (time.perf_counter() - t0))
        ms[name] = float(np.median(times[1:]))
    a, b = out.values()
    say("service", f"static aux stack {tuple(b.shape)} ({b.numel() * 4 / 1e6:.1f} MB), host, "
        f"median of {reps}: " + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
        + f"; equal {torch.equal(a, b)}")
    if not torch.equal(a, b):
        raise AssertionError("_stack_channels differs from np.stack")


def encode_check(model, task, phase: str = "service", what: str = "the loader's shape") -> float:
    """B1 against its plain version on each station set of a task a loader
    built (its point capacity, per-time padding and missing rows), with the
    model's own length scales; returns the largest error. These launches
    are not counted: the caller reads its counts before this runs and
    resets them after."""
    import torch

    from deepsensornz_tpu_torch.ops import setconv, setconv_cuda

    worst = 0.0
    with torch.inference_mode():
        for i, p in enumerate(task.points):
            args = (task.x1g, task.x2g, p.x, p.y, p.mask, model.lengthscale(f"ls_points_{i}"))
            got = setconv_cuda.encode_offgrid(*args)
            torch.cuda.synchronize()
            cmp = compare(got, setconv.setconv_encode_offgrid(*args), RTOL, ATOL_FRAC)
            say(phase, f"encode_offgrid at {what} {tuple(p.x.shape)} "
                f"({int(p.mask.sum())} of {p.mask.numel()} slots filled) -> {tuple(got.shape)}: "
                f"max_abs_err {cmp['max_abs_err']:.3e} max_rel_err {cmp['max_rel_err']:.3e} "
                f"(rtol {RTOL}, atol {cmp['atol']:.3e})")
            if not cmp["ok"]:
                raise AssertionError(f"encode_offgrid disagrees with its plain version at "
                                     f"{what} ({phase})")
            worst = max(worst, cmp["max_abs_err"])
    return worst


def grad_check(phase: str, label: str, ls, task, seed: int) -> tuple[float, tuple]:
    """B1's l-gradient against its plain version in float64 on the first
    station set of ``task`` (on the card), for a random upstream gradient, a
    density-only one and one positive on every channel, twice each (the
    result must not change from run to run); returns the largest error, the
    kernel's arguments and the random upstream."""
    import torch

    from deepsensornz_tpu_torch.ops import setconv, setconv_cuda

    p = task.points[0]
    pts = (task.x1g, task.x2g, p.x, p.y, p.mask)
    gen = torch.Generator(device=task.x1g.device).manual_seed(seed)
    shape = (p.x.shape[0], task.x1g.shape[0], task.x2g.shape[0], p.y.shape[-1] + 1)
    g_random = torch.randn(shape, generator=gen, device=gen.device)
    # the density channel alone: summands of one sign, nothing cancels
    g_density = torch.zeros(shape, device=gen.device)
    g_density[..., 0] = 0.5 + torch.rand(shape[:3], generator=gen, device=gen.device)
    # every channel positive: the value channels' terms without the random
    # sign's cancellation across cells
    g_positive = 0.5 + torch.rand(shape, generator=gen, device=gen.device)
    with torch.no_grad():  # the forward's output, as the backward gets it
        fwd = setconv_cuda.encode_offgrid(*pts, ls)
    max_err = 0.0
    filled = f"{int(p.mask.sum())} of {p.mask.numel()} slots filled"
    for gname, g in (("random", g_random), ("density", g_density), ("positive", g_positive)):
        got = setconv_cuda.encode_offgrid_grad(*pts, ls, g, fwd)
        again = setconv_cuda.encode_offgrid_grad(*pts, ls, g, fwd)
        terms = setconv.encode_offgrid_grad_ls_terms(*pts, ls.double(), g.double())
        ref = float(sum(t.sum() for t in terms))
        bound = GRAD_RTOL * abs(ref) + GRAD_SUM_TOL * float(sum(t.abs().sum() for t in terms))
        err = abs(float(got) - ref)
        max_err = max(max_err, err)
        say(phase, f"encode_offgrid_grad {label} {shape} ({filled}) g {gname}: got "
            f"{float(got):.9g} float64 {ref:.9g}; abs err {err:.3e}, rel err "
            f"{err / abs(ref):.3e}, bound {GRAD_RTOL} * |ref| + {GRAD_SUM_TOL} * sum|terms| = "
            f"{bound:.3e}; deterministic {bool(torch.equal(got, again))}")
        if err > bound:
            raise AssertionError(f"encode_offgrid_grad disagrees with its plain version "
                                 f"({phase} {label}, g {gname})")
        if not torch.equal(got, again):
            raise AssertionError("encode_offgrid_grad changed from run to run")
        del terms
    return max_err, pts + (ls, g_random, fwd)


def kernel_device_ms(fn, kernel: str, reps: int = TIMING_REPS) -> float:
    """Device time per launch of the CUDA kernel whose name holds
    ``kernel``, over ``reps`` calls of ``fn`` under ``torch.profiler``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if kernel in e.key:
            return (getattr(e, "device_time_total", None) or e.cuda_time_total) / 1e3 / e.count
    raise AssertionError(f"the profiler saw no {kernel} kernel")


def grad_timing(phase: str, label: str, args) -> dict:
    """B1's l-gradient on ``grad_check``'s arguments: CUDA-event times of
    the wrapper and of the plain f32 autograd backward, the points the
    kernel keeps per tile, the share of cells reached, the bound by the work
    these inputs need and the kernel's share of it."""
    import torch

    from deepsensornz_tpu_torch.ops import setconv, setconv_cuda

    pts, ls, g = args[:5], args[5], args[6]
    x1g, x2g, x, _, mask = pts
    ms = cuda_ms(lambda: setconv_cuda.encode_offgrid_grad(*args))
    dev_ms = kernel_device_ms(lambda: setconv_cuda.encode_offgrid_grad(*args),
                              "encode_offgrid_grad_kernel")
    ls_req = ls.clone().requires_grad_(True)
    enc = setconv.setconv_encode_offgrid(*pts, ls_req)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(enc, ls_req, g, retain_graph=True))
    del enc
    kept = setconv_cuda.grad_tile_points(x1g, x2g, x, mask, ls).sum(-1).float()
    reached = float(reached_cells(setconv, x1g, x2g, x, mask, ls).float().mean())
    bnd = card_bound(*encode_work(setconv, *pts, ls, grad=True))
    say(phase, f"encode_offgrid_grad {label} {tuple(g.shape)}: wrapper {ms:.4f} ms, kernel "
        f"alone {dev_ms:.4f} ms (profiler, device time per launch), plain f32 "
        f"autograd backward {plain_ms:.3f} ms (CUDA events, median of {TIMING_REPS}); "
        f"points kept per {setconv_cuda.GRAD_TILE}x{setconv_cuda.GRAD_TILE} tile mean "
        f"{float(kept.mean()):.1f}, largest "
        f"{float(kept.max()):.0f} of {x.shape[1]}, empty tiles "
        f"{100 * float((kept == 0).float().mean()):.1f} %; cells reached {100 * reached:.2f} %; "
        f"bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']} (the reached cells' upstream "
        f"and output); bound / wrapper {100 * bnd['bound_ms'] / ms:.1f} %, bound / kernel "
        f"alone {100 * bnd['bound_ms'] / dev_ms:.1f} %")
    return {"ms": ms, "plain_ms": plain_ms, **bnd}


@contextlib.contextmanager
def grad_out_strides(setconv_cuda):
    """Records (shape, strides, contiguous) of each upstream gradient B1's
    backward receives inside the block; yields the list."""
    fn = setconv_cuda._EncodeOffgrid
    saved = fn.__dict__["backward"]
    seen = []

    def backward(ctx, grad_out):
        seen.append((tuple(grad_out.shape), grad_out.stride(), grad_out.is_contiguous()))
        return saved.__func__(ctx, grad_out)

    fn.backward = staticmethod(backward)
    try:
        yield seen
    finally:
        fn.backward = saved


def sample_serve(dev, model, dp, dem, aux_field, target_var, setconv_cuda) -> dict:
    """Phase 6: a sampled 24-task request (twice, one seed) and a chunked
    48-task request against two unchunked ones; returns the launch counts."""
    import torch

    from deepsensornz_tpu_torch.infer.predict import Predictor
    from deepsensornz_tpu_torch.task.batching import take

    predictor = Predictor(model, dp, target_var)
    task = cycle_task(31, N_TASKS, model.cfg.internal_density)
    land = ~np.isnan(dem.data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    setconv_cuda.reset_launch_counts()
    preds = []
    for i in range(2):
        pred, ms, wall = timed(lambda: predictor.predict_grid(
            task, dem, aux_at_targets=aux_field, n_samples=N_SAMPLES, seed=SAMPLE_SEED))
        preds.append(pred)
        say("sample-serve", f"request {i} ({N_TASKS} tasks, {N_SAMPLES} samples): {ms:.1f} ms "
            f"(CUDA events), {wall:.3f} s wall")
    peak = torch.cuda.max_memory_allocated(dev)
    check_prediction(pred, dem, N_TASKS)
    smp = pred["samples"].data
    if smp.shape != (N_SAMPLES, N_TASKS) + dem.shape:
        raise AssertionError(f"samples shape {smp.shape}")
    if not np.isfinite(smp[..., land]).all() or not np.isnan(smp[..., ~land]).all():
        raise AssertionError("samples not finite on land and NaN on sea")
    same = np.array_equal(preds[0]["samples"].data, smp, equal_nan=True)
    dev_mean = np.abs(smp[..., land].mean(0) - pred["mean"].data[:, land])
    share = float((dev_mean <= 4.0 * pred["std"].data[:, land] / np.sqrt(N_SAMPLES)).mean())
    say("sample-serve", f"peak memory {peak / 2**30:.2f} GiB; samples {smp.shape}, land mean "
        f"{np.mean(smp[..., land]):.4f} std {np.std(smp[..., land]):.4f}; same seed same samples "
        f"{same}; per-cell sample mean within 4 std/sqrt({N_SAMPLES}) of the mean on "
        f"{100 * share:.3f} % of land cells")
    if not same:
        raise AssertionError("the same seed gave different samples")
    if share < 0.99:
        raise AssertionError(f"sample means off the mean map on {100 * (1 - share):.2f} % of land")

    task48 = cycle_task(32, 2 * N_TASKS, model.cfg.internal_density)
    torch.cuda.reset_peak_memory_stats(dev)
    chunked = Predictor(model, dp, target_var, batch_chunk=N_TASKS)
    big, ms, wall = timed(lambda: chunked.predict_grid(task48, dem, aux_at_targets=aux_field))
    peak = torch.cuda.max_memory_allocated(dev)
    check_prediction(big, dem, 2 * N_TASKS)
    halves = [predictor.predict_grid(take(task48, list(range(i * N_TASKS, (i + 1) * N_TASKS))),
                                     dem, aux_at_targets=aux_field) for i in range(2)]
    errs = []
    for key in ("mean", "std"):
        ref = np.concatenate([h[key].data[:, land] for h in halves])
        cmp = compare(torch.from_numpy(big[key].data[:, land]), torch.from_numpy(ref),
                      CHUNK_RTOL, ATOL_FRAC)
        errs.append(f"{key} max_abs_err {cmp['max_abs_err']:.3e}")
        if not cmp["ok"]:
            raise AssertionError(f"chunked {key} disagrees with the unchunked requests")
    counts = setconv_cuda.launch_counts()
    say("sample-serve", f"chunked request ({2 * N_TASKS} tasks, batch_chunk={N_TASKS}): "
        f"{ms:.1f} ms (CUDA events), {wall:.3f} s wall, peak memory {peak / 2**30:.2f} GiB; "
        f"against two {N_TASKS}-task requests: {', '.join(errs)} (rtol {CHUNK_RTOL}); "
        f"launches {counts}")
    for name in ("encode_offgrid", "decode_grid"):
        if counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the sampled requests")
    return counts


def ar_phase(dev, model, dp, dem, aux_field, target_var, setconv_cuda) -> dict:
    """Phase 7: ar_sample at perf/ar_bench.py's shape, then ar_sample_grid
    on the NZ grid; returns the launch counts."""
    import torch

    from deepsensornz_tpu_torch.infer import ar
    from deepsensornz_tpu_torch.infer.predict import Predictor

    task = train_task(40, N_TASKS, model.cfg.internal_density)  # 512 targets, one aux channel
    n_blocks = ar.block_geometry(N_TARGETS, AR_BLOCKS)[1]  # 8 blocks of 64
    gen = torch.Generator(device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    setconv_cuda.reset_launch_counts()
    ms_all, wall_all = [], []
    for i in range(1 + AR_REPS):
        before = setconv_cuda.launch_counts()["encode_offgrid"]
        gen.manual_seed(i)
        smp, ms, wall = timed(lambda: ar.ar_sample(model, task, n_samples=1,
                                                   n_blocks=AR_BLOCKS, generator=gen))
        b1 = setconv_cuda.launch_counts()["encode_offgrid"] - before
        ms_all.append(ms)
        wall_all.append(wall)
        say("ar", f"ar_sample call {i}{' (warm-up)' if i == 0 else ''}: {ms:.1f} ms (CUDA "
            f"events), {wall:.3f} s wall; B1 launched {b1} times; sample mean "
            f"{smp.mean():.4f} std {smp.std():.4f}")
        if smp.shape != (1, N_TASKS, N_TARGETS, 1) or not np.isfinite(smp).all():
            raise AssertionError(f"ar_sample gave {smp.shape}, finite {np.isfinite(smp).all()}")
        if b1 != n_blocks:
            raise AssertionError(f"B1 launched {b1} times in one {n_blocks}-block AR sample")
    peak = torch.cuda.max_memory_allocated(dev)
    say("ar", f"median of {AR_REPS} calls ({N_TASKS} tasks x {N_TARGETS} targets, {n_blocks} "
        f"blocks, 1 sample): {float(np.median(ms_all[1:])):.1f} ms (CUDA events), "
        f"{float(np.median(wall_all[1:])):.3f} s wall; peak memory {peak / 2**30:.2f} GiB")

    grid_task = cycle_task(41, AR_GRID_TASKS, model.cfg.internal_density)
    grid_m = len(range(0, dem.shape[0], AR_SUBSAMPLE)) * len(range(0, dem.shape[1], AR_SUBSAMPLE))
    grid_blocks = ar.block_geometry(grid_m, AR_BLOCKS)[1]  # 8 at the NZ grid's 70x65 points
    before = setconv_cuda.launch_counts()["encode_offgrid"]
    torch.cuda.reset_peak_memory_stats(dev)
    out, ms, wall = timed(lambda: Predictor(model, dp, target_var).ar_sample_grid(
        grid_task, dem, aux_at_targets=aux_field, subsample_factor=AR_SUBSAMPLE,
        n_blocks=AR_BLOCKS, seed=3))
    b1 = setconv_cuda.launch_counts()["encode_offgrid"] - before
    peak = torch.cuda.max_memory_allocated(dev)
    sea = np.isnan(dem.data)
    say("ar", f"ar_sample_grid ({AR_GRID_TASKS} tasks, {dem.shape} grid, subsample "
        f"{AR_SUBSAMPLE}: {grid_m} points in {grid_blocks} blocks): {out.shape}, {ms:.1f} ms (CUDA events), {wall:.3f} s wall, peak "
        f"memory {peak / 2**30:.2f} GiB; B1 launched {b1} times; land mean "
        f"{np.mean(out[..., ~sea]):.4f} std {np.std(out[..., ~sea]):.4f}")
    if out.shape != (1, AR_GRID_TASKS) + dem.shape:
        raise AssertionError(f"ar_sample_grid shape {out.shape}")
    if not np.isnan(out[..., sea]).all() or not np.isfinite(out[..., ~sea]).all():
        raise AssertionError("ar_sample_grid not NaN on sea and finite on land")
    if b1 != grid_blocks:
        raise AssertionError(f"B1 launched {b1} times in the {grid_blocks}-block grid AR sample")
    counts = setconv_cuda.launch_counts()
    say("ar", f"launches {counts}")
    return counts


def record_rounds(alg) -> list:
    """Wraps a ``GreedyAlgorithm`` so that each round's candidate scores
    are kept (host copies): the exhaustive acquisitions, or in fast mode
    the predictive std at the candidates. Returns the list they go to."""
    rounds = []
    if alg.mode == "fast":
        predict = alg._predict

        def keep_std(task):
            mean, std = predict(task)
            rounds.append(std[0, :, 0].cpu())
            return mean, std
        alg._predict = keep_std
    else:
        scores = alg._exhaustive_scores_dev

        def keep_scores(*args):
            sc = scores(*args)
            rounds.append(sc.cpu())
            return sc
        alg._exhaustive_scores_dev = keep_scores
    return rounds


def round_margins(rounds, placed, mode: str) -> list[tuple[float, float, float]]:
    """Per round of a greedy run: (best score, runner-up, largest |score|)
    over the candidates still in the pool; fails if the round's placement
    (index ``placed[t]``) is not the best."""
    out = []
    for t, sc in enumerate(rounds):
        sc = sc.double().numpy()
        free = np.setdiff1d(np.arange(len(sc)), placed[:t])
        order = free[np.argsort(-sc[free] if mode == "fast" else sc[free], kind="stable")]
        if order[0] != placed[t]:
            raise AssertionError(f"round {t} placed candidate {placed[t]}, "
                                 f"not the best {order[0]}")
        out.append((float(sc[order[0]]), float(sc[order[1]]), float(np.abs(sc).max())))
    return out


def placement_indices(cands: np.ndarray, placements: np.ndarray) -> list[int]:
    """The candidate row of each placement (-1 where none equals it)."""
    return [int(np.flatnonzero((cands == p).all(1))[0]) if (cands == p).all(1).any() else -1
            for p in placements]


def host_syncs(fn) -> tuple[object, list[tuple[str, bool]]]:
    """``fn()``'s result and the synchronising CUDA calls it made (torch's
    sync debug mode): for each, the innermost line of the port on the stack
    and whether it ran inside a greedy chain (``_run_chain``)."""
    import traceback
    import warnings

    import torch

    found = []

    def show(message, *args, **kwargs):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        port = [f for f in stack if "deepsensornz_tpu_torch" in f.filename]
        site = (f"{Path(port[-1].filename).name}:{port[-1].lineno} {port[-1].line}" if port
                else "outside the port")
        found.append((site, any(f.name == "_run_chain" for f in stack)))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, found


def device_ops(trace: Path, top: int = 5) -> tuple[list, float, float]:
    """From a ``torch.profiler`` Chrome trace: the ``top`` device ops by
    total time as (name, ms, calls), the device's busy time and the span
    from its first op's start to its last op's end (ms)."""
    events = json.loads(trace.read_text())["traceEvents"]
    ops = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not ops:
        return [], 0.0, 0.0
    by_name: dict = {}
    for e in ops:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + float(e["dur"]) / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    busy = sum(float(e["dur"]) for e in ops) / 1e3
    span = (max(float(e["ts"]) + float(e["dur"]) for e in ops)
            - min(float(e["ts"]) for e in ops)) / 1e3
    return [(name, ms, n) for name, (ms, n) in ranked], busy, span


def al_phase(dev, model, setconv, setconv_cuda) -> tuple[dict, float]:
    """Phase 9: greedy placement with the flagship at perf/al_bench.py's
    shape, exhaustive then fast; returns the launch counts of the timed runs
    and B1's largest error against its plain version at the exhaustive
    shape."""
    import torch

    from deepsensornz_tpu_torch.al import GreedyAlgorithm, Stddev
    from deepsensornz_tpu_torch.infer.ar import _extend_point_context
    from deepsensornz_tpu_torch.perf.harness import benchmark_fn, profile_trace

    task = train_task(50, 1, model.cfg.internal_density).to(dev)  # 512 targets, one aux channel
    rng = np.random.default_rng(3)
    cands = rng.random((AL_CANDIDATES, 2)).astype(np.float32)
    cand_aux = rng.normal(size=(AL_CANDIDATES, 1)).astype(np.float32)
    acq = Stddev()
    with torch.inference_mode():
        before = float(acq(*GreedyAlgorithm(model)._predict(task), task.yt_mask)[0])
    counts = dict.fromkeys(setconv_cuda.launch_counts(), 0)
    for mode, b1_per_round in (("exhaustive", 2), ("fast", 1)):
        alg = GreedyAlgorithm(model, mode=mode)

        def run(n=AL_PLACEMENTS):
            return alg.run(task, cands, n_placements=n, candidate_aux=cand_aux)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        setconv_cuda.reset_launch_counts()
        with plain_calls_on_card(setconv) as plain:
            bench = benchmark_fn(run, warmup=1, reps=AL_REPS)
            out, ms, wall = timed(run)
        launches = setconv_cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        n_runs = 1 + AL_REPS + 1
        hist = np.asarray(out["acquisition_history"])
        placed = placement_indices(cands, out["placements"])
        final = out["final_task"]
        with torch.inference_mode():
            after = float(acq(*alg._predict(final), final.yt_mask)[0])
        syncs = host_syncs(run)[1]
        in_chain = [site for site, inside in syncs if inside]
        say("al", f"{mode}: run({AL_CANDIDATES} candidates, {AL_PLACEMENTS} placements) "
            f"benchmark_fn p50 {bench['p50_s']:.4f} s, min {bench['min_s']:.4f} s over "
            f"{bench['reps']} reps ({bench['p50_s'] / AL_PLACEMENTS:.4f} s per placement); one "
            f"more run {ms:.1f} ms (CUDA events), {wall:.4f} s wall; peak memory "
            f"{peak / 2**30:.2f} GiB; launches in {n_runs} runs {launches}; plain versions "
            f"called on the card {dict(plain)}; host synchronisations in one run "
            f"{len(syncs)}, {len(in_chain)} inside the rounds: "
            + "; ".join(f"{site} x{n}" for site, n in
                        collections.Counter(site for site, _ in syncs).items()))
        say("al", f"{mode}: placements {out['placements'].tolist()} (candidates {placed}); "
            f"history {hist.tolist()}; Stddev initial {before:.7f}, final {after:.7f}")
        if -1 in placed or len(set(placed)) != AL_PLACEMENTS:
            raise AssertionError(f"{mode}: placements not distinct candidates: {placed}")
        if not np.isfinite(hist).all():
            raise AssertionError(f"{mode}: non-finite acquisition history {hist}")
        if after > before + AL_STDDEV_SLACK:
            raise AssertionError(f"{mode}: the placements raised the Stddev acquisition "
                                 f"({before} -> {after})")
        if (launches["encode_offgrid"] != n_runs * AL_PLACEMENTS * b1_per_round
                or launches["decode_grid"] or launches["encode_offgrid_grad"]):
            raise AssertionError(f"{mode}: launches {launches} in {n_runs} runs")
        if any(plain.values()):
            raise AssertionError(f"{mode}: a plain SetConv ran on the card")
        if in_chain:
            raise AssertionError(f"{mode}: the rounds synchronised with the host: {in_chain}")
        for k in counts:
            counts[k] += launches[k]

    # B1 against its plain version at the exhaustive forward's shape: the
    # station set with its masked placement slots and one candidate per task
    ext = dataclasses.replace(task, points=(_extend_point_context(task.points[0],
                                                                  AL_PLACEMENTS),))
    feed = torch.from_numpy(rng.normal(size=(AL_CANDIDATES, 1)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        tiled = GreedyAlgorithm.hypothetical_tasks(ext, torch.from_numpy(cands).to(dev), feed, 0)
        err = encode_check(model, tiled, "al", "the exhaustive forward's shape")
        p = tiled.points[0]
        args = (tiled.x1g, tiled.x2g, p.x, p.y, p.mask, model.lengthscale("ls_points_0"))
        ms = cuda_ms(lambda: setconv_cuda.encode_offgrid(*args))
        plain_ms = cuda_ms(lambda: setconv.setconv_encode_offgrid(*args))
        work = encode_work(setconv, *args)
    bnd = card_bound(*work)
    say("al", f"encode_offgrid at {tuple(p.x.shape)}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"(CUDA events, median of {TIMING_REPS}); needed {work[0] / 1e9:.3f} GFLOP, "
        f"{work[1] / 1e6:.1f} MB: bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}")
    del tiled, args, p, ext

    # one exhaustive run under the profiler
    alg = GreedyAlgorithm(model, mode="exhaustive")
    with tempfile.TemporaryDirectory() as tmp:
        with profile_trace(tmp) as log_dir:
            alg.run(task, cands, n_placements=AL_PLACEMENTS, candidate_aux=cand_aux)
            torch.cuda.synchronize()
        ops, busy, span = device_ops(Path(log_dir) / "trace.json")
    if ops:
        say("al", f"profiled exhaustive run: device busy {busy:.1f} ms of a {span:.1f} ms span "
            f"({100 * busy / span:.1f} %); top device ops: " + "; ".join(
                f"{name[:70]} {t:.1f} ms x{n}" for name, t, n in ops))
    else:
        say("al", "profiled exhaustive run: the trace holds no device op (not measured)")
    say("al", f"launches {counts}")
    return counts, err


def al_reference(dev) -> None:
    """Phase 10: a small ConvNP's greedy placement on the GPU (kernels)
    against the CPU (plain versions), in both modes: each round's
    candidate scores within the reference tolerance, each round decisive
    (the CPU's best ahead of its runner-up by more than twice the largest
    GPU-CPU score difference of the round), the same placements, and the
    histories and final context set within the tolerance."""
    import torch

    from deepsensornz_tpu_torch.al import GreedyAlgorithm
    from deepsensornz_tpu_torch.models.convnp import ConvNPConfig

    small = ConvNPConfig(unet_channels=(8, 8), likelihood="gnp", internal_density=40,
                         rank=4, decoder_channels=8, mlp_hidden=8, compute_dtype="float32")
    task = train_task(8, 1, small.internal_density, base_hw=(12, 11), aux_hw=(30, 28),
                      n_stations=AL_REF_STATIONS, n_targets=20)
    rng = np.random.default_rng(AL_REF_SEED)
    cands = rng.random((AL_REF_CANDIDATES, 2)).astype(np.float32)
    cand_aux = rng.normal(size=(AL_REF_CANDIDATES, 1)).astype(np.float32)
    for mode in ("exhaustive", "fast"):
        got, rounds = {}, {}
        for role, d in (("cpu", torch.device("cpu")), ("gpu", dev)):
            alg = GreedyAlgorithm(build_model(small, task, seed=3, device=d), mode=mode)
            rounds[role] = record_rounds(alg)
            got[role] = alg.run(task, cands, n_placements=AL_REF_PLACEMENTS,
                                candidate_aux=cand_aux)
        g, c = got["gpu"], got["cpu"]
        placed = placement_indices(cands, c["placements"])
        scores = [compare(gs, cs_, REF_RTOL, REF_ATOL_FRAC)
                  for gs, cs_ in zip(rounds["gpu"], rounds["cpu"])]
        score_errs = [sc["max_abs_err"] for sc in scores]
        decisive = [abs(best - second) / max(2 * e, 1e-30)
                    for (best, second, _), e in zip(round_margins(rounds["cpu"], placed, mode),
                                                    score_errs)]
        same = np.array_equal(g["placements"], c["placements"])
        hist = compare(torch.tensor(g["acquisition_history"]),
                       torch.tensor(c["acquisition_history"]), REF_RTOL, REF_ATOL_FRAC)
        ctx = {k: compare(getattr(g["final_task"].points[0], k).cpu(),
                          getattr(c["final_task"].points[0], k), REF_RTOL, REF_ATOL_FRAC)
               for k in ("x", "y", "mask")}
        say("al-reference", f"{mode}: placements GPU {placement_indices(cands, g['placements'])} "
            f"CPU {placed}, same {same}; per-round candidate scores GPU vs CPU max_abs_err "
            f"{', '.join(f'{e:.3e}' for e in score_errs)}; CPU margin over "
            f"twice that {', '.join(f'{r:.3g}' for r in decisive)}; history max_abs_err "
            f"{hist['max_abs_err']:.3e}; final context max_abs_err "
            + ", ".join(f"{k} {v['max_abs_err']:.3e}" for k, v in ctx.items())
            + f" (rtol {REF_RTOL}, atol {REF_ATOL_FRAC} x max)")
        if not all(sc["ok"] for sc in scores):
            raise AssertionError(f"{mode}: candidate scores on the GPU disagree with the CPU")
        if min(decisive) <= 1.0:
            raise AssertionError(f"{mode}: a round is a near-tie; the comparison cannot decide")
        if not same or not hist["ok"] or not all(v["ok"] for v in ctx.values()):
            raise AssertionError(f"{mode}: greedy placement on the GPU disagrees with the CPU")


def kernel_checks(dev, model, dp, dem, task0) -> dict:
    """Phase 3: each kernel against its plain version at the main path's
    shapes (and B1 at the AR feedback shapes); returns per-kernel results
    at the main shape, with the largest error over its shapes."""
    import torch

    from deepsensornz_tpu_torch.infer import ar
    from deepsensornz_tpu_torch.ops import setconv, setconv_cuda

    cfg = model.cfg
    results = {}
    with torch.inference_mode():
        task = task0.to(dev)
        p = task.points[0]
        ls_pts = model.lengthscale("ls_points_0")
        enc_args = (task.x1g, task.x2g, p.x, p.y, p.mask, ls_pts)
        f = model.features(task)  # bf16, channel-first memory seen as NHWC
        xt1 = torch.from_numpy(dp.map_x1(dem.coords["latitude"]).astype(np.float32)).to(dev)
        xt2 = torch.from_numpy(dp.map_x2(dem.coords["longitude"]).astype(np.float32)).to(dev)
        ls_dec = model.lengthscale("ls_decoder")
        # the flagship path hands the U-Net's bf16 output to the decode; the
        # f32 path (f32 U-Net, hoisted head) is held at a smaller depth
        f4 = f[:F32_TASKS].float()
        B, H, W, C = f.shape
        Ht, Wt = dem.shape
        dec_flop = 2.0 * C * (Ht * H * W + Ht * W * Wt)  # per task, both contractions, dense
        # the AR feedback shapes: the station set with its masked feedback
        # slots, as ar_sample extends it (x = -1e3, y = 0, mask = 0)
        ar_b = ar.block_geometry(N_TARGETS, AR_BLOCKS)
        grid_m = len(range(0, Ht, AR_SUBSAMPLE)) * len(range(0, Wt, AR_SUBSAMPLE))
        ar_g = ar.block_geometry(grid_m, AR_BLOCKS)
        pe = ar._extend_point_context(p, ar_b[0] * ar_b[1])
        task4 = cycle_task(3, AR_GRID_TASKS, cfg.internal_density).to(dev)
        pg = ar._extend_point_context(task4.points[0], ar_g[0] * ar_g[1])
        cases = {
            "encode_offgrid": (setconv_cuda.encode_offgrid, setconv.setconv_encode_offgrid,
                               enc_args, 2.0 * B * H * W * p.x.shape[1] * (p.y.shape[-1] + 1)),
            "decode_grid": (setconv_cuda.decode_grid, setconv.setconv_decode_grid,
                            (task.x1g, task.x2g, f, xt1, xt2, ls_dec), B * dec_flop),
            "decode_grid_f32": (setconv_cuda.decode_grid, setconv.setconv_decode_grid,
                                (task.x1g, task.x2g, f4, xt1, xt2, ls_dec), F32_TASKS * dec_flop),
            "encode_offgrid_ar_feedback": (
                setconv_cuda.encode_offgrid, setconv.setconv_encode_offgrid,
                (task.x1g, task.x2g, pe.x, pe.y, pe.mask, ls_pts),
                2.0 * B * H * W * pe.x.shape[1] * (pe.y.shape[-1] + 1)),
            "encode_offgrid_ar_grid": (
                setconv_cuda.encode_offgrid, setconv.setconv_encode_offgrid,
                (task4.x1g, task4.x2g, pg.x, pg.y, pg.mask, ls_pts),
                2.0 * AR_GRID_TASKS * H * W * pg.x.shape[1] * (pg.y.shape[-1] + 1)),
        }
        for name, (kernel, plain, args, flop) in cases.items():
            got = kernel(*args)
            torch.cuda.synchronize()
            cmp = compare(got, plain(*args), RTOL, ATOL_FRAC)
            ms = cuda_ms(lambda: kernel(*args))
            plain_ms = cuda_ms(lambda: plain(*args))
            work = (encode_work(setconv, *args) if kernel is setconv_cuda.encode_offgrid
                    else decode_work(setconv, *args))
            bnd = card_bound(*work)
            lib = ""
            library_ms = None
            if name == "decode_grid":
                # one PyTorch call for the same function: the normalised
                # weights contracted with the same f in f32 (TF32 off)
                A = setconv.rbf(xt1[:, None], task.x1g[None, :], ls_dec)
                Bm = setconv.rbf(task.x2g[:, None], xt2[None, :], ls_dec)
                A = A / (A.sum(1, keepdim=True) + setconv.DENSITY_EPS)
                Bm = Bm / (Bm.sum(0, keepdim=True) + setconv.DENSITY_EPS)
                fcf = f.permute(0, 3, 1, 2).float()
                library_ms = cuda_ms(lambda: torch.einsum("th,bchw,wu->bctu", A, fcf, Bm))
                lib = f", library einsum {library_ms:.3f} ms"
                del A, Bm, fcf
            say("kernels", f"{name} {tuple(args[2].shape)} -> {tuple(got.shape)}: max_abs_err "
                f"{cmp['max_abs_err']:.3e} max_rel_err {cmp['max_rel_err']:.3e} (rtol {RTOL}, "
                f"atol {cmp['atol']:.3e}) kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{lib}; "
                f"dense {flop / 1e9:.1f} GFLOP ({flop / ms / 1e9:.1f} TFLOP/s); needed "
                f"{work[0] / 1e9:.2f} GFLOP, {work[1] / 1e6:.1f} MB: bound {bnd['bound_ms']:.4f} ms "
                f"by {bnd['bound_by']}")
            if not cmp["ok"]:
                raise AssertionError(f"{name} disagrees with its plain version")
            entry = results.setdefault(name.replace("_f32", "").replace("_ar_feedback", "")
                                       .replace("_ar_grid", ""), {})
            if not entry:  # the first case of each kernel is its main-path shape
                entry.update({"ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": library_ms})
            entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0), cmp["max_abs_err"])
        del f, f4, got, task, task4, pe, pg
    return results


def serve_reference(dev, dp, target_var) -> None:
    """Phase 8: a small ConvNP on the GPU (kernels) against the same weights
    on the CPU (plain versions): ``predict_grid``, ``predict_points``, and
    the AR chain over one visit order with the head's sample replaced by
    its mean (deterministic, so both devices must agree)."""
    import torch

    from deepsensornz_tpu_torch.infer import ar
    from deepsensornz_tpu_torch.infer.predict import Predictor
    from deepsensornz_tpu_torch.models.convnp import ConvNPConfig

    small = ConvNPConfig(unet_channels=(8, 8), likelihood="gnp", internal_density=40,
                         rank=4, decoder_channels=8, mlp_hidden=8, compute_dtype="float32")
    sdem, saux = target_fields(dp, (30, 28), seed=1)
    stask = cycle_task(4, 3, small.internal_density, base_hw=(12, 11), aux_hw=(30, 28),
                       n_stations=40)
    ptask = train_task(6, 3, small.internal_density, base_hw=(12, 11), aux_hw=(30, 28),
                       n_stations=40, n_targets=20)
    models = {"gpu": build_model(small, stask, seed=1, device=dev),
              "cpu": build_model(small, stask, seed=1, device="cpu")}
    got = {}
    for k, m in models.items():
        pred = Predictor(m, dp, target_var)
        grid = pred.predict_grid(stask, sdem, aux_at_targets=saux)
        pts = pred.predict_points(ptask)
        got[k] = {"grid mean": grid["mean"].data[:, ~np.isnan(sdem.data)],
                  "grid std": grid["std"].data[:, ~np.isnan(sdem.data)],
                  "points mean": pts["mean"], "points std": pts["std"]}
    block, n_blocks, pad = ar.block_geometry(ptask.num_targets, 3)
    order = torch.cat([torch.arange(ptask.num_targets), torch.arange(pad)]).repeat(3, 1)
    head = type(small.make_likelihood())
    sample = head.sample
    head.sample = lambda self, raw, gen, n: self.mean_std(raw)[0][None]
    try:
        for k, m in models.items():
            d = next(m.parameters()).device
            t = ptask.to(d)
            t = dataclasses.replace(t, points=(ar._extend_point_context(t.points[0],
                                                                        n_blocks * block),))
            got[k]["AR chain (mean feedback)"] = ar.run_chain(
                m, t, order.to(d), torch.Generator(device=d), 1.0, idx=0,
                base_n=ptask.points[0].x.shape[1], n_extra=0, block=block,
                n_blocks=n_blocks, pad=pad).cpu().numpy()
    finally:
        head.sample = sample
    for key in got["cpu"]:
        cmp = compare(torch.from_numpy(np.asarray(got["gpu"][key])),
                      torch.from_numpy(np.asarray(got["cpu"][key])), REF_RTOL, REF_ATOL_FRAC)
        say("reference", f"{key}: GPU vs CPU max_abs_err {cmp['max_abs_err']:.3e} "
            f"(rtol {REF_RTOL}, atol {cmp['atol']:.3e})")
        if not cmp["ok"]:
            raise AssertionError(f"small-model {key} on the GPU disagrees with the CPU")


def train_kernels(dev, model, setconv, setconv_cuda) -> dict:
    """Phase 11: B1's backward against its plain version in float64 and
    timed at the training, serving and clustered shapes; returns the
    training shape's numbers."""
    import torch

    ls = model.lengthscale("ls_points_0").detach()
    out = {}
    for label, n_tasks in (("train", N_TRAIN_TASKS), ("serve", N_TASKS),
                           ("corner", N_TRAIN_TASKS)):
        task = grad_task(n_tasks, model.cfg.internal_density, label == "corner").to(dev)
        max_err, args = grad_check("train-kernels", label, ls, task, seed=n_tasks)
        res = grad_timing("train-kernels", label, args)
        if label == "train":
            out = {"max_abs_err": max_err, **res, "library_ms": None}
            B, H, W = args[6].shape[:3]
            tile = setconv_cuda.GRAD_TILE
            partials = torch.rand((B, -(-H // tile), -(-W // tile)), dtype=torch.float64,
                                  device=dev)
            fold_ms = cuda_ms(lambda: (partials.sum() / ls.double()).float())
            say("train-kernels", f"train: the partials' sum, division and cast in torch "
                f"{fold_ms:.4f} ms (CUDA events), {100 * fold_ms / (res['ms'] + fold_ms):.0f} % "
                f"of the wrapper with them; the kernel's last block does them instead")
            wide = torch.full_like(ls, 0.3)
            with torch.no_grad():
                fwd_wide = setconv_cuda.encode_offgrid(*args[:5], wide)
            wide_args = args[:5] + (wide, args[6], fwd_wide)
            kept = setconv_cuda.grad_tile_points(*args[:3], args[4], wide).sum(-1)
            wide_ms = cuda_ms(lambda: setconv_cuda.encode_offgrid_grad(*wide_args))
            say("train-kernels", f"train at l = 0.3: kernel {wide_ms:.4f} ms with "
                f"{int(kept.min())}-{int(kept.max())} points kept per tile (CUDA events)")
            del fwd_wide, wide_args
        else:
            out["max_abs_err"] = max(out["max_abs_err"], max_err)
        del args, task
    return out


def train_flagship(dev, model, cfg, setconv_cuda) -> dict:
    """Phase 12: the flagship train step at perf/train_bench.py's shape;
    returns the launch counts of the run."""
    import torch

    from deepsensornz_tpu_torch.train.trainer import init_state, make_train_step, train_epoch

    task = train_task(20, N_TRAIN_TASKS, cfg.internal_density).to(dev)
    epoch_tasks = train_task(21, N_TRAIN_TASKS * TRAIN_STEPS, cfg.internal_density)  # host
    state = init_state(model)
    p0 = {k: v.clone() for k, v in state.params.items()}
    step = make_train_step(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    setconv_cuda.reset_launch_counts()
    losses, step_ms, step_s = [], [], []
    for i in range(1 + TRAIN_STEPS):
        if i == 0:  # the warm-up step records the upstream's layout
            with grad_out_strides(setconv_cuda) as seen:
                (state, loss), ms, wall = timed(lambda: step(state, task, TRAIN_LR))
            say("train", f"B1's upstream gradient arrives as (shape, strides, contiguous) "
                f"{seen}: read in place")
        else:
            (state, loss), ms, wall = timed(lambda: step(state, task, TRAIN_LR))
        step_ms.append(ms)
        step_s.append(wall)
        losses.append(float(loss))
        say("train", f"step {i}{' (warm-up)' if i == 0 else ''}: {step_ms[-1]:.1f} ms "
            f"(CUDA events), {step_s[-1]:.4f} s wall; loss {losses[-1]:.6f}")
    say("train", f"median of {TRAIN_STEPS} steps {float(np.median(step_ms[1:])):.1f} ms (CUDA "
        f"events), {float(np.median(step_s[1:])):.4f} s wall; "
        f"{N_TRAIN_TASKS / float(np.median(step_s[1:])):.2f} tasks/s at batch {N_TRAIN_TASKS} "
        f"(median step)")
    # the window: one epoch as a user runs it, synchronise to synchronise
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, epoch_losses = train_epoch(model, state, epoch_tasks, batch_size=N_TRAIN_TASKS,
                                      lr=TRAIN_LR, step_fn=step)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    losses += epoch_losses
    n_steps = 1 + TRAIN_STEPS + len(epoch_losses)
    counts = setconv_cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    moved = sum(not torch.equal(state.params[k], p0[k]) for k in p0)
    say("train", f"train_epoch window: {epoch_tasks.batch_size} tasks in {len(epoch_losses)} "
        f"batches, {window_s:.4f} s wall, {epoch_tasks.batch_size / window_s:.2f} tasks/s; "
        f"losses {', '.join(f'{v:.6f}' for v in epoch_losses)}")
    say("train", f"peak memory {peak / 2**30:.2f} GiB; {moved} of {len(p0)} parameters moved "
        f"in {n_steps} steps; launches {counts}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses}")
    if moved == 0:
        raise AssertionError("the train steps changed no parameter")
    for name in ("encode_offgrid", "encode_offgrid_grad"):
        if counts[name] < n_steps:
            raise AssertionError(f"kernel {name} launched {counts[name]} times in "
                                 f"{n_steps} train steps")
    return counts


@contextlib.contextmanager
def stage_timers(targets: dict):
    """Each ``(owner, attribute)`` of ``targets`` replaced by a
    :class:`Timed` stand-in for the block (yielded by name), then put back."""
    saved = {name: getattr(owner, attr) for name, (owner, attr) in targets.items()}
    timers = {name: Timed(fn) for name, fn in saved.items()}
    try:
        for name, (owner, attr) in targets.items():
            setattr(owner, attr, timers[name])
        yield timers
    finally:
        for name, (owner, attr) in targets.items():
            setattr(owner, attr, saved[name])


@contextlib.contextmanager
def plain_calls_on_card(setconv):
    """Counts, per name, the calls of the kernels' plain versions made with
    tensors on the card (the kernel wrappers call them for CPU tensors
    only); yields the counts."""
    import torch

    names = ("setconv_encode_offgrid", "setconv_encode_offgrid_grad_ls", "setconv_decode_grid")
    saved = {n: getattr(setconv, n) for n in names}
    counts = dict.fromkeys(names, 0)

    def counting(name):
        def call(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                counts[name] += 1
            return saved[name](*args, **kwargs)
        return call

    try:
        for n in names:
            setattr(setconv, n, counting(n))
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(setconv, n, fn)


def pipeline_phase(dev, cfg, setconv, setconv_cuda) -> tuple[dict, dict, dict]:
    """Phase 13: synthetic data -> preprocessing -> ``Train`` at ``cfg``'s
    width -> a run directory -> ``PredictService``, then phase 14
    (:func:`validate_phase`) on the same run directory; returns the launch
    counts of training and serving together, the largest error of each
    kernel against its plain version on the pipeline's and validation's own
    tasks, and the launch counts of validation."""
    import torch

    from deepsensornz_tpu_torch.data.synthetic import synthetic_bundle
    from deepsensornz_tpu_torch.infer.server import PredictService
    from deepsensornz_tpu_torch.pipeline import train as ptrain
    from deepsensornz_tpu_torch.pipeline.preprocess import PreprocessForDownscaling
    from deepsensornz_tpu_torch.task.batching import take
    from deepsensornz_tpu_torch.train import checkpoint, trainer

    t_phase = t0 = time.perf_counter()
    base, dem, stations = synthetic_bundle("temperature", n_times=PIPELINE_TIMES,
                                           base_hw=(139, 130), dem_hw=PIPELINE_DEM_HW,
                                           n_stations=N_STATIONS, seed=0)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bundle = PreprocessForDownscaling("temperature").run_processing_sequence(
        dem, {"temperature": base}, stations, highres_factor=DEM_FACTOR, lowres_factor=50,
        include_time_of_year=True)
    pre_s = time.perf_counter() - t0
    grids = {k: "x".join(map(str, next(iter(bundle[k].values())).shape[-2:] + (len(bundle[k]),)))
             for k in ("base_ds", "highres_aux_ds", "aux_ds")}
    say("pipeline", f"synthetic data ({PIPELINE_TIMES} times, base {base.shape[1:]}, DEM {dem.shape}, "
        f"{len(stations)} station rows) {gen_s:.3f} s; preprocessing {pre_s:.3f} s: base "
        f"{grids['base_ds']}, highres aux {grids['highres_aux_ds']}, lowres aux "
        f"{grids['aux_ds']}, {len(bundle['station_df'])} station rows, columns "
        f"{bundle['station_df'].columns}")

    t0 = time.perf_counter()
    tr = ptrain.Train(bundle)
    tl = tr.setup_task_loader(internal_density=cfg.internal_density)
    setup_s = time.perf_counter() - t0
    say("pipeline", f"Train on {tr.device}, loader set-up {setup_s:.3f} s: internal grid "
        f"{len(tl.x1g)}x{len(tl.x2g)}, point capacity {tl.point_capacity}")
    if (len(tl.x1g), len(tl.x2g)) != (608, 608):
        raise AssertionError("the pipeline's internal grid is not the flagship's 608x608")
    tr.initialise_model(unet_channels=cfg.unet_channels, likelihood=cfg.likelihood,
                        rank=cfg.rank, decoder_channels=cfg.decoder_channels,
                        mlp_hidden=cfg.mlp_hidden)
    tr.create_tasks = Timed(tr.create_tasks)
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = Path(tmp) / "run"
        targets = {"epoch": (trainer, "train_epoch"), "fit_std_scale": (ptrain, "fit_std_scale"),
                   "save_task_loader": (ptrain, "save_task_loader"),
                   "save_checkpoint": (checkpoint, "save_checkpoint"),
                   "update_metadata": (ptrain, "update_metadata")}
        with stage_timers(targets) as timers, plain_calls_on_card(setconv) as plain:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            setconv_cuda.reset_launch_counts()
            t0 = time.perf_counter()
            out = tr.train_model(n_epochs=PIPELINE_EPOCHS, batch_size=N_TRAIN_TASKS,
                                 model_dir=str(run_dir), verbose=False)
            train_s = time.perf_counter() - t0
            train_counts = setconv_cuda.launch_counts()
            train_peak = torch.cuda.max_memory_allocated(dev)
            plain_train = dict(plain)
        wall = {k: [c["wall_s"] for c in t.calls] for k, t in timers.items()}
        tasks_s = [c["wall_s"] for c in tr.create_tasks.calls]
        writes_s = sum(sum(wall[k]) for k in ("save_task_loader", "save_checkpoint",
                                               "update_metadata"))
        layout = ("the JAX package's" if b"pandas" in (run_dir / "task_loader.pkl").read_bytes()
                  else "the port's")
        say("pipeline", f"train_model {train_s:.3f} s wall: task building "
            f"{' + '.join(f'{t:.3f}' for t in tasks_s)} s (train, validation times), epochs "
            f"{', '.join(f'{t:.3f}' for t in wall['epoch'])} s (training steps; validation "
            f"and checkpoint outside), fit_std_scale {sum(wall['fit_std_scale']):.3f} s, writes "
            f"{writes_s:.3f} s (task_loader.pkl {sum(wall['save_task_loader']):.3f}, "
            f"{len(wall['save_checkpoint'])} checkpoints {sum(wall['save_checkpoint']):.3f}, "
            f"metadata {sum(wall['update_metadata']):.3f}); peak memory "
            f"{train_peak / 2**30:.2f} GiB; task_loader.pkl in {layout} layout")
        say("pipeline", f"train losses {out['train_losses']}, validation losses "
            f"{out['val_losses']}; std_scale {out.get('std_scale')}; launches {train_counts}; "
            f"plain versions called on the card {plain_train}")
        losses = out["train_losses"] + out["val_losses"]
        if len(out["train_losses"]) != PIPELINE_EPOCHS or not np.isfinite(losses).all():
            raise AssertionError(f"pipeline training losses {losses}")
        lo, hi = STD_SCALE_RANGE
        if not lo <= out.get("std_scale", np.nan) <= hi:
            raise AssertionError(f"std_scale {out.get('std_scale')} outside [{lo}, {hi}]")
        # B1 and its l-gradient against their plain versions on one training
        # batch of the pipeline's loader (ragged station sets in masked
        # slots), with the trained length scales; outside the counts above
        batch = take(tr.create_tasks.calls[0]["out"], list(range(N_TRAIN_TASKS))).to(dev)
        errs = {"encode_offgrid": encode_check(tr.model, batch, "pipeline")}
        errs["encode_offgrid_grad"], grad_args = grad_check(
            "pipeline", "train batch", tr.model.lengthscale("ls_points_0").detach(), batch,
            seed=N_TRAIN_TASKS)
        grad_timing("pipeline", "train batch", grad_args)
        del grad_args
        del tr, out, batch

        t0 = time.perf_counter()
        svc = PredictService(str(run_dir), dem, highres_factor=DEM_FACTOR)
        load_s = time.perf_counter() - t0
        loader = svc.run["task_loader"] = Timed(svc.run["task_loader"])
        forward = svc.predictor.predict_grid = Timed(svc.predictor.predict_grid,
                                                     cuda_events=True)
        sea = np.isnan(svc.pred_grid.data)
        times = base.coords["time"]
        serve_counts = dict.fromkeys(setconv_cuda.launch_counts(), 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with plain_calls_on_card(setconv) as plain:
            # the first and the last 24 days
            for i, start in enumerate((0, len(times) - N_TASKS)):
                window = times[start: start + N_TASKS]
                req = [str(t) for t in window]
                setconv_cuda.reset_launch_counts()
                t0 = time.perf_counter()
                resp = svc.predict(req)
                total_s = time.perf_counter() - t0
                launches = setconv_cuda.launch_counts()
                for k, v in launches.items():
                    serve_counts[k] += v
                task, fwd = loader.calls[-1]["out"], forward.calls[-1]
                direct = forward.fn(task, svc.pred_grid, aux_at_targets=loader.aux_at_targets,
                                    times=np.asarray(window))
                same = {}
                for key in ("mean", "std"):
                    got = np.asarray(resp[key], np.float32)
                    want = np.nan_to_num(direct[key].data, nan=-9999.0)
                    same[key] = (got.shape == (len(window),) + svc.pred_grid.shape
                                 and got.tobytes() == want.tobytes()
                                 and bool(((got == -9999.0) == sea).all()))
                loader_s = loader.calls[-1]["wall_s"]
                say("pipeline", f"request {i} ({len(req)} times from {req[0]}): {total_s:.3f} s "
                    f"wall = loader {loader_s:.4f} s + predict_grid {fwd['wall_s']:.4f} s "
                    f"({fwd['ms']:.1f} ms CUDA events) + response "
                    f"{total_s - loader_s - fwd['wall_s']:.4f} s; launches {launches}; bitwise "
                    f"equal to a direct predict_grid with sea -9999: {same}")
                if launches["encode_offgrid"] != 1 or launches["decode_grid"] != 1:
                    raise AssertionError(f"request {i} launched {launches}, not B1 and B2 once")
                if not all(same.values()):
                    raise AssertionError(f"request {i}: the response differs from predict_grid")
            plain_serve = dict(plain)
        serve_peak = torch.cuda.max_memory_allocated(dev)
        # B1 against its plain version on the last request's 24-time task
        errs["encode_offgrid"] = max(errs["encode_offgrid"], encode_check(
            svc.predictor.model, loader.calls[-1]["out"].to(dev), "pipeline"))
        del svc
        validate_counts, validate_errs = validate_phase(dev, run_dir, base, dem, stations,
                                                        setconv, setconv_cuda)
        for name, err in validate_errs.items():
            errs[name] = max(errs.get(name, 0.0), err)
    say("pipeline", f"PredictService load {load_s:.3f} s; serving peak memory "
        f"{serve_peak / 2**30:.2f} GiB; launches {serve_counts}; plain versions called on the "
        f"card {plain_serve}; the phase {time.perf_counter() - t_phase:.1f} s wall")
    for name in ("encode_offgrid", "encode_offgrid_grad"):
        if train_counts[name] == 0:
            raise AssertionError(f"pipeline training did not launch {name}")
    if any(plain_train.values()) or any(plain_serve.values()):
        raise AssertionError("a plain SetConv ran on the card in the pipeline")
    return {k: train_counts[k] + serve_counts[k] for k in train_counts}, errs, validate_counts


def decode_check(model, task, dp, grid, phase: str) -> float:
    """B2 against its plain version on the features of a task a loader
    built, decoded onto ``grid``'s cells with the model's own length scale;
    returns the largest error. Not counted, as :func:`encode_check`."""
    import torch

    from deepsensornz_tpu_torch.ops import setconv, setconv_cuda

    dev = next(model.parameters()).device
    with torch.inference_mode():
        f = model.features(task.to(dev))
        xt1 = torch.from_numpy(dp.map_x1(grid.coords["latitude"]).astype(np.float32)).to(dev)
        xt2 = torch.from_numpy(dp.map_x2(grid.coords["longitude"]).astype(np.float32)).to(dev)
        args = (task.x1g.to(dev), task.x2g.to(dev), f, xt1, xt2, model.lengthscale("ls_decoder"))
        got = setconv_cuda.decode_grid(*args)
        torch.cuda.synchronize()
        cmp = compare(got, setconv.setconv_decode_grid(*args), RTOL, ATOL_FRAC)
    say(phase, f"decode_grid on the request's features {tuple(f.shape)} {f.dtype} -> "
        f"{tuple(got.shape)}: max_abs_err {cmp['max_abs_err']:.3e} max_rel_err "
        f"{cmp['max_rel_err']:.3e} (rtol {RTOL}, atol {cmp['atol']:.3e})")
    if not cmp["ok"]:
        raise AssertionError(f"decode_grid disagrees with its plain version ({phase})")
    return cmp["max_abs_err"]


def validate_phase(dev, run_dir: Path, base, dem, stations, setconv, setconv_cuda):
    """Phase 14: the pipeline's run directory validated on the card:
    ``Validate``'s metrics on the validation times with a holdout,
    ``ValidateERA`` on 24 times from the raw base and stations, then the
    transfer modes on a 72-time request in chunks of 24. Returns the launch
    counts of the validation calls and each kernel's largest error against
    its plain version on validation's own tasks."""
    import torch

    from deepsensornz_tpu_torch.infer.predict import Predictor
    from deepsensornz_tpu_torch.pipeline.validate import Validate, ValidateERA, _nearest_index

    t_phase = time.perf_counter()
    times = base.coords["time"]
    dates = list(times[-VALIDATE_TIMES:])
    held = [str(i) for i in range(VALIDATE_HELD)]
    lat_c, lon_c = dem.coords["latitude"], dem.coords["longitude"]

    def dem_lookup(lat, lon):
        return float(dem.data[_nearest_index(lat_c, [lat])[0], _nearest_index(lon_c, [lon])[0]])

    box = (float(stations["latitude"].min()) - 1e-6,
           float(np.quantile(stations["latitude"], VALIDATE_BOX_QUANTILE)))
    sel = stations[np.isin(stations["time"], np.asarray(dates, stations["time"].dtype))]
    totals = dict.fromkeys(setconv_cuda.launch_counts(), 0)
    rows, errs = {}, {}

    def run(name, fn, b1=None, b2=0):
        """One call under CUDA events; its launches added to the totals and
        held to ``b1`` B1 and ``b2`` B2 launches where given."""
        setconv_cuda.reset_launch_counts()
        out, ms, wall = timed(fn)
        launches = setconv_cuda.launch_counts()
        for k, v in launches.items():
            totals[k] += v
        rows[name] = (wall, ms)
        say("validate", f"{name}: {wall:.4f} s wall, {ms:.2f} ms CUDA events; launches "
            f"{launches}")
        if b1 is not None and (launches["encode_offgrid"], launches["decode_grid"]) != (b1, b2):
            raise AssertionError(f"{name} launched {launches}, not B1 {b1} and B2 {b2} times")
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with plain_calls_on_card(setconv) as plain:
        v = run("Validate(run_dir)", lambda: Validate(str(run_dir)), 0)
        loss = run("calculate_loss", lambda: v.calculate_loss(dates, held), 1)
        bands = run("elevation_band_errors (errors passed)", lambda: v.elevation_band_errors(
            dates, elevation_lookup=dem_lookup, errors=loss["errors"], xt=loss["xt"]), 0)
        cal = run("calibration_stats", lambda: v.calibration_stats(dates, held), 1)
        pit = run("pit_stats", lambda: v.pit_stats(dates, held), 1)
        crps = run("crps", lambda: v.crps(dates, held), 1)
        ext = run("extrapolation_loss", lambda: v.extrapolation_loss(dates, lat_range=box), 1)
        lb = run("calculate_loss_base", lambda: v.calculate_loss_base(base, sel), 0)
        ps = run("per_station_loss_base", lambda: v.per_station_loss_base(base, stations, dates),
                 0)
        era = run("ValidateERA(run_dir, dem, highres_factor=10)", lambda: ValidateERA(
            str(run_dir), dem, highres_factor=DEM_FACTOR), 0)
        loader = era.run["task_loader"] = Timed(era.run["task_loader"])
        swap = era._swapped_task = Timed(era._swapped_task)
        forward = era.predictor.predict_grid = Timed(era.predictor.predict_grid,
                                                     cuda_events=True)
        req = times[:N_TASKS]
        req_sel = stations[np.isin(stations["time"], np.asarray(req, stations["time"].dtype))]
        preds = []
        for i in range(2):
            pred = run(f"ValidateERA.predict {i}{' (warm-up)' if i == 0 else ''} ({N_TASKS} times)",
                       lambda: era.predict(req, {"temperature": base}, station_df=req_sel,
                                           remove_stations=held), 1, 1)
            total = rows[next(reversed(rows))][0]
            swap_s, load_s = swap.calls[-1]["wall_s"], loader.calls[-1]["wall_s"]
            fwd = forward.calls[-1]
            say("validate", f"  = normalise+swap {swap_s - load_s:.4f} s + loader {load_s:.4f} s"
                f" + predict_grid {fwd['wall_s']:.4f} s ({fwd['ms']:.1f} ms CUDA events) + rest "
                f"{total - swap_s - fwd['wall_s']:.4f} s")
            preds.append(pred)
    peak = torch.cuda.max_memory_allocated(dev)
    plain = dict(plain)

    # outside the counted calls: the checks
    task = swap.calls[-1]["out"]
    direct = forward.fn(task, era.pred_grid, aux_at_targets=loader.aux_at_targets,
                        times=np.asarray(req))
    same = {k: preds[-1][k].data.tobytes() == direct[k].data.tobytes() for k in ("mean", "std")}
    vtask = v._make_tasks(dates, held)
    full = v._make_tasks(dates)
    tgt = v.task_loader.target
    ids = tgt["station_id"].astype(str)
    xy = np.stack([tgt["x1"], tgt["x2"]], -1).astype(np.float32)
    held_xy = {tuple(c) for c in xy[np.isin(ids, held)]}
    absent = present = True
    for b in range(len(dates)):
        ctx = {tuple(x) for x in vtask.points[0].x[b][vtask.points[0].mask[b] > 0].numpy()}
        before = {tuple(x) for x in full.points[0].x[b][full.points[0].mask[b] > 0].numpy()}
        targets = {tuple(x) for x in vtask.xt[b][vtask.yt_mask[b] > 0].numpy()}
        absent &= not ctx & held_xy and ctx == before - held_xy
        present &= (before & held_xy) <= targets and bool(targets & held_xy)
    errs["encode_offgrid"] = encode_check(v.predictor.model, vtask.to(dev), "validate")
    errs["decode_grid"] = decode_check(era.predictor.model, task, era.predictor.dp,
                                       era.pred_grid, "validate")
    metrics = {"rmse": loss["rmse"], "mae": loss["mae"], "bias": loss["bias"],
               "z_mean": cal["z_mean"], "z_std": cal["z_std"], "coverage_95": cal["coverage_95"],
               "pit_z_std": pit["z_std"], "pit_coverage_95": pit["coverage_95"],
               "crps": crps["crps"], "extrapolation_rmse": ext["extrapolation"]["rmse"],
               "interpolation_rmse": ext["interpolation"]["rmse"], "base_rmse": lb["rmse"],
               "base_mae": lb["mae"], "base_mean_of_means": ps["mean_of_means"]}
    say("validate", f"{len(dates)} validation times, {len(held)} stations held out ({int(
        full.points[0].mask.sum() - vtask.points[0].mask.sum())} context points), n "
        f"{cal['n']}; " + ", ".join(f"{k} {val:.4f}" for k, val in metrics.items()))
    band_sizes = {k: len(e) for k, e in bands["bands"].items()}
    say("validate", f"elevation bands (stations): {band_sizes}; extrapolation box lat "
        f"{box[0]:.3f}..{box[1]:.3f}: {len(ext['held_out_stations'])} stations, n "
        f"{ext['extrapolation']['n']} / {ext['interpolation']['n']}; held-out stations absent "
        f"from the context {absent}, present in the targets {present}; "
        f"ValidateERA bitwise equal to a direct predict_grid on its swapped task {same}; "
        f"peak memory {peak / 2**30:.2f} GiB; plain versions called on the card {plain}")
    if not np.isfinite(list(metrics.values())).all():
        raise AssertionError(f"non-finite validation metrics {metrics}")
    for key in ("z_std", "pit_z_std"):
        if not Z_STD_WINDOW[0] <= metrics[key] <= Z_STD_WINDOW[1]:
            raise AssertionError(f"{key} {metrics[key]} outside {Z_STD_WINDOW}")
    for key in ("coverage_95", "pit_coverage_95"):
        if not COVERAGE_95_WINDOW[0] <= metrics[key] <= COVERAGE_95_WINDOW[1]:
            raise AssertionError(f"{key} {metrics[key]} outside {COVERAGE_95_WINDOW}")
    if not metrics["crps"] > 0 or not ext["held_out_stations"]:
        raise AssertionError("CRPS not positive, or no station in the extrapolation box")
    if not (absent and present):
        raise AssertionError("the held-out stations are in the context or missing from targets")
    if not all(same.values()):
        raise AssertionError("ValidateERA.predict differs from predict_grid on its task")
    if any(plain.values()):
        raise AssertionError("a plain SetConv ran on the card in validation")
    del v, vtask, full, direct, preds

    # the transfer modes: a 72-time request (three overlapping 24-day windows)
    windows = [times[i: i + N_TASKS] for i in (0, 8, 16)]
    t72 = np.concatenate(windows)
    task72 = era._swapped_task.fn(t72, {"temperature": base}, stations)
    model, dp, vids = era.predictor.model, era.predictor.dp, era.run["task_loader"].target_var_IDs
    aux = era.run["task_loader"].aux_at_targets
    scale, offset = era.predictor._affines()
    land = ~np.isnan(era.pred_grid.data)
    results = {}
    for up in (None, "float16"):
        for t in (None, "float16", "int16", "int8"):
            for threads in (1, 8):
                p = Predictor(model, dp, vids, std_scale=era.predictor.std_scale,
                              transfer_dtype=t, batch_chunk=N_TASKS, download_threads=threads,
                              upload_dtype=up)
                if not results:  # one warm-up of the chunked path
                    p.predict_grid(task72, era.pred_grid, aux_at_targets=aux, times=t72)
                setconv_cuda.reset_launch_counts()
                out, ms, wall = timed(lambda: p.predict_grid(task72, era.pred_grid,
                                                             aux_at_targets=aux, times=t72))
                for k, n in setconv_cuda.launch_counts().items():
                    totals[k] += n
                results[(up, t, threads)] = (out, wall, ms, p.last_timings)
    eps = float(np.finfo(np.float32).eps)
    for (up, t, threads), (out, wall, ms, lt) in results.items():
        ref = results[(up, None, 1)][0]
        bits = {"int16": 16, "int8": 8}.get(t)
        worst, over = {}, False
        for key in ("mean", "std"):
            r = ref[key].data.astype(np.float64)
            err = np.abs(out[key].data - r)
            mag = np.abs(r - offset[0]) if key == "mean" else np.abs(r)
            if bits:
                span = (np.nanmax(r, axis=(1, 2), keepdims=True)
                        - np.nanmin(r, axis=(1, 2), keepdims=True))
                bound = span / (2 ** bits - 1) / 2
            elif t == "float16":
                bound = F16_HALF_ULP * mag
            else:
                bound = np.zeros_like(r)
            bound = bound + 4 * eps * np.nanmax(np.abs(r), axis=(1, 2), keepdims=True)
            worst[key] = float(err[:, land].max())
            over |= bool((err[:, land] > np.broadcast_to(bound, r.shape)[:, land]).any())
        bitwise = all(out[k].data.tobytes() == results[(up, t, 1)][0][k].data.tobytes()
                      for k in ("mean", "std"))
        say("validate", f"transfer {t or 'float32'}, upload {up or 'float32'}, {threads} "
            f"download threads ({TRANSFER_TIMES} times, chunks of {N_TASKS}): {wall:.4f} s wall, "
            f"{ms:.1f} ms CUDA events, last_timings {lt}; max_abs_err against float32 mean "
            f"{worst['mean']:.3e} std {worst['std']:.3e} (within its bound {not over}); "
            f"bitwise equal to 1 thread {bitwise}")
        if over or not bitwise:
            raise AssertionError(f"transfer mode {(up, t, threads)} outside its bound or not "
                                 "bitwise equal to one download thread")
    # the float16 upload's own effect, on float32 maps
    up_err = {}
    for key in ("mean", "std"):
        a = results[("float16", None, 1)][0][key].data
        r = results[(None, None, 1)][0][key].data.astype(np.float64)
        mag = np.abs(r - offset[0]) if key == "mean" else np.abs(r)
        up_err[key] = float(np.abs(a - r)[:, land].max())
        if up_err[key] > UPLOAD_F16_BOUND * float(np.nanmax(mag)):
            raise AssertionError(f"the float16 upload moved {key} by {up_err[key]}")
    say("validate", f"float16 upload against float32, float32 transfer: max_abs_err mean "
        f"{up_err['mean']:.3e} std {up_err['std']:.3e} (bound {UPLOAD_F16_BOUND} x the map's "
        f"largest normalised value x {abs(scale[0]):.3f}); launches {totals}; the phase "
        f"{time.perf_counter() - t_phase:.1f} s wall")
    return totals, errs


def validate_reference(dev, setconv) -> None:
    """Phase 15: ``Validate`` on a small ConvNP of each head, on the GPU
    (kernels) and on the CPU (plain versions) from the same weights and run
    dict: ``calculate_loss``, ``calibration_stats``, ``pit_stats``,
    ``crps`` (the mixed heads on the same fixed samples, then once from the
    card's own generator) and, for bernoulli-gamma, ``wet_dry_skill``."""
    import torch

    from deepsensornz_tpu_torch.data.processor import DataProcessor
    from deepsensornz_tpu_torch.models.convnp import ConvNPConfig
    from deepsensornz_tpu_torch.pipeline.validate import Validate
    from deepsensornz_tpu_torch.task.loader import TaskLoader

    heads = {"gnp": ("temperature", {"method": "mean_std", "params": {"mean": 12.0, "std": 5.0}}),
             "cnp": ("temperature", {"method": "mean_std", "params": {"mean": 12.0, "std": 5.0}}),
             "bernoulli-gamma": ("precipitation", {"method": "positive_semidefinite",
                                                   "params": {"std": 4.0}}),
             "cnp-spikes-beta": ("humidity", {"method": "min_max",
                                              "params": {"min": 0.0, "max": 100.0}})}
    for i, (likelihood, (variable, norm)) in enumerate(heads.items()):
        target = f"{variable}_station"
        times, base, aux, highres, stations = service_data(
            60 + i, n_times=6, base_hw=(12, 11), aux_hw=(30, 28), highres_hw=(36, 34),
            n_stations=40, target_var=target)
        v = stations[target]
        if likelihood == "bernoulli-gamma":
            stations[target] = np.maximum(v, 0.0) * 2.0  # dry (0) about half the time
        elif likelihood == "cnp-spikes-beta":
            stations[target] = np.clip(0.5 + 0.4 * v, 0.0, 1.0)  # spikes at 0 and 1
        tl = TaskLoader([base, aux, stations], stations, aux_at_targets=highres,
                        internal_density=40)
        dp = DataProcessor()
        dp.config[target] = norm
        small = ConvNPConfig(unet_channels=(8, 8), likelihood=likelihood, internal_density=40,
                             rank=4, decoder_channels=8, mlp_hidden=8, compute_dtype="float32")
        example = tl(list(times[:1]))
        dates = list(times[:4])
        held = ["0", "1", "2"]
        B, M, n = len(dates), tl.target_capacity, 32
        r = np.random.default_rng(i).random((n, B, M, 1))
        xs = torch.from_numpy(np.where(r < 0.3, 0.0, np.where(r > 0.9, 1.0, r)).astype(np.float32))
        head = type(small.make_likelihood())
        got = {}
        with plain_calls_on_card(setconv) as plain:
            for d in (dev, torch.device("cpu")):
                model = build_model(small, example, seed=11 + i, device=d)
                val = Validate(run={"model": model, "params": model.state_dict(),
                                    "task_loader": tl, "data_processor": dp, "metadata": {},
                                    "variable": variable, "std_scale": 0.8})
                res = {"loss": val.calculate_loss(dates, held),
                       "cal": val.calibration_stats(dates, held), "pit": val.pit_stats(dates, held)}
                if likelihood in ("bernoulli-gamma", "cnp-spikes-beta"):
                    own = val.crps(dates, held, n_samples=n)["crps"]
                    sample = head.sample
                    head.sample = lambda self, raw, gen, m: xs[:m].to(raw.device)
                    try:
                        res["crps"] = val.crps(dates, held, n_samples=n)
                    finally:
                        head.sample = sample
                    res["own generator crps"] = own
                else:
                    res["crps"] = val.crps(dates, held)
                if likelihood == "bernoulli-gamma":
                    res["wet"] = val.wet_dry_skill(dates, remove_stations=held)
                got[d.type] = res
        g, c = got["cuda"], got["cpu"]
        pairs = {"rmse": (g["loss"]["rmse"], c["loss"]["rmse"], VAL_REF_RTOL),
                 "z_mean": (g["cal"]["z_mean"], c["cal"]["z_mean"], VAL_REF_RTOL),
                 "z_std": (g["cal"]["z_std"], c["cal"]["z_std"], VAL_REF_RTOL),
                 "pit z_mean": (g["pit"]["z_mean"], c["pit"]["z_mean"], VAL_REF_PIT_RTOL),
                 "pit z_std": (g["pit"]["z_std"], c["pit"]["z_std"], VAL_REF_PIT_RTOL),
                 "crps": (g["crps"]["crps"], c["crps"]["crps"], VAL_REF_RTOL)}
        if likelihood == "bernoulli-gamma":
            pairs["brier"] = (g["wet"]["brier"], c["wet"]["brier"], VAL_REF_RTOL)
        bad = [k for k, (a, b, tol) in pairs.items()
               if not (np.isfinite(a) and abs(a - b) <= tol * abs(b) + tol)]
        for key in ("cal", "pit"):
            nn = c[key]["n"]
            if g[key]["n"] != nn or abs(g[key]["coverage_95"] - c[key]["coverage_95"]) > 1.0 / nn:
                bad.append(f"{key} coverage")
        if likelihood == "bernoulli-gamma" and abs(g["wet"]["hit_rate"]
                                                   - c["wet"]["hit_rate"]) > 1.0 / c["wet"]["n"]:
            bad.append("hit_rate")
        own = g.get("own generator crps")
        say("validate-reference", f"{likelihood}: " + ", ".join(
            f"{k} GPU {a:.6f} CPU {b:.6f}" for k, (a, b, _) in pairs.items())
            + f"; coverage_95 GPU {g['cal']['coverage_95']:.4f} CPU {c['cal']['coverage_95']:.4f}"
            + (f"; crps from the card's generator {own:.6f}" if own is not None else "")
            + f"; plain versions called on the card {dict(plain)}")
        if bad or (own is not None and not own > 0) or any(plain.values()):
            raise AssertionError(f"{likelihood}: validation on the GPU disagrees with the CPU: "
                                 f"{bad}")


def train_reference(dev, setconv_cuda) -> None:
    """Phase 16: a small train step on the GPU (kernels) against the CPU
    (plain versions) from the same weights and batch."""
    import torch

    from deepsensornz_tpu_torch.models.convnp import ConvNPConfig
    from deepsensornz_tpu_torch.train.trainer import init_state, make_train_step

    small = ConvNPConfig(unet_channels=(8, 8), likelihood="gnp", internal_density=40,
                         rank=4, decoder_channels=8, mlp_hidden=8, compute_dtype="float32")
    task = train_task(5, 3, small.internal_density, base_hw=(12, 11), aux_hw=(30, 28),
                      n_stations=40, n_targets=20)
    lr = 1e-3
    setconv_cuda.reset_launch_counts()
    res = {}
    for d in (dev, torch.device("cpu")):
        m = build_model(small, task, seed=2, device=d)
        td = task.to(d)
        names = [k for k, _ in m.named_parameters()]
        loss = m.loss(td)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        state = init_state(m)
        state2, step_loss = make_train_step(m, weight_decay=1e-2)(state, td, lr)
        res[d.type] = (float(loss.detach()), float(step_loss),
                       {k: g.cpu() for k, g in zip(names, grads)},
                       {k: ((state2.params[k] - state.params[k]) / lr).cpu() for k in names})
    (gl, gsl, gg, gu), (cl, csl, cg, cu) = res["cuda"], res["cpu"]
    worst = {"grad": 0.0, "update": 0.0}
    bad = []
    n_held = n_all = 0
    for k in cg:
        err = (gg[k] - cg[k]).abs()
        tol = TRAIN_REF_RTOL * cg[k].abs() + TRAIN_REF_ATOL_FRAC * float(cg[k].abs().max())
        worst["grad"] = max(worst["grad"], float((err / (tol + 1e-30)).max()))
        if bool((err > tol).any()):
            bad.append(f"grad {k}")
        held = (cg[k].abs() >= TRAIN_REF_STEP_MIN_GRAD) & (cg[k].abs() >= 10.0 * tol)
        n_held += int(held.sum())
        n_all += held.numel()
        uerr = float(torch.where(held, (gu[k] - cu[k]).abs(), 0.0).max())
        worst["update"] = max(worst["update"], uerr)
        if uerr > TRAIN_REF_STEP_ATOL:
            bad.append(f"update {k}")
    counts = setconv_cuda.launch_counts()
    say("train-reference", f"loss GPU {gl:.7f} CPU {cl:.7f}; step loss GPU {gsl:.7f} CPU "
        f"{csl:.7f}; {len(cg)} gradients, worst err/tol {worst['grad']:.3f}; worst "
        f"update err/lr {worst['update']:.3e} (bound {TRAIN_REF_STEP_ATOL}) over {n_held} of "
        f"{n_all} elements; GPU launches {counts}")
    for a, b in ((gl, cl), (gsl, csl)):
        if not abs(a - b) <= TRAIN_REF_RTOL * abs(b):
            raise AssertionError(f"small-model loss on the GPU {a} disagrees with the CPU {b}")
    if bad:
        raise AssertionError(f"small-model train step on the GPU disagrees with the CPU: {bad}")
    if counts["encode_offgrid_grad"] == 0:
        raise AssertionError("the GPU train step did not launch encode_offgrid_grad")


def cli_train_phase(dev, cfg, setconv, setconv_cuda) -> dict:
    """Phase 17: a YAML through the training CLI at ``cfg``'s width, the
    run directory it writes loaded and served; returns the launch counts of
    the training and the request."""
    import torch
    import yaml

    from deepsensornz_tpu_torch import paths
    from deepsensornz_tpu_torch.cli import train_downscaling as cli
    from deepsensornz_tpu_torch.infer.server import PredictService
    from deepsensornz_tpu_torch.pipeline.preprocess import PreprocessForDownscaling
    from deepsensornz_tpu_torch.pipeline.train import Train
    from deepsensornz_tpu_torch.pipeline.validate import load_run

    args = {"variable": "temperature", "model_name": "cli_smoke", "synthetic": True,
            "n_epochs": CLI_EPOCHS, "batch_size": N_TRAIN_TASKS, "lr": TRAIN_LR,
            "unet_channels": list(cfg.unet_channels), "likelihood": cfg.likelihood,
            "internal_density": int(cfg.internal_density), "highres_coarsen_factor": 2,
            "lowres_coarsen_factor": 4, "include_time_of_year": True}
    targets = {"load_synthetic_data": (cli, "load_synthetic_data"),
               "preprocess": (PreprocessForDownscaling, "run_processing_sequence"),
               "setup_task_loader": (Train, "setup_task_loader"),
               "initialise_model": (Train, "initialise_model"),
               "train_model": (Train, "train_model")}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        arg_path = Path(tmp) / "args.yaml"
        arg_path.write_text(yaml.safe_dump(args))
        paths.set_data_paths({"save_model": {"fpath": str(Path(tmp) / "models")}})
        try:
            with stage_timers(targets) as timers, plain_calls_on_card(setconv) as plain:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                setconv_cuda.reset_launch_counts()
                t0 = time.perf_counter()
                run_dir = Path(cli.main(["-arg_path", str(arg_path)]))
                torch.cuda.synchronize()
                main_s = time.perf_counter() - t0
                train_counts = setconv_cuda.launch_counts()
                plain_train = dict(plain)
        finally:
            paths._DATA_PATHS = None
        peak = torch.cuda.max_memory_allocated(dev)
        wall = {k: sum(c["wall_s"] for c in t.calls) for k, t in timers.items()}
        out = timers["train_model"].calls[0]["out"]
        base, dem, _ = timers["load_synthetic_data"].calls[0]["out"]
        files = sorted(p.name for p in run_dir.iterdir())
        say("cli-train", f"main {main_s:.3f} s wall = synthetic data "
            f"{wall['load_synthetic_data']:.3f} + preprocessing {wall['preprocess']:.3f} + "
            f"loader set-up {wall['setup_task_loader']:.3f} + model {wall['initialise_model']:.3f}"
            f" + train_model {wall['train_model']:.3f} + rest "
            f"{main_s - sum(wall.values()):.3f} s; peak memory {peak / 2**30:.2f} GiB; run "
            f"directory {run_dir.relative_to(tmp)}: {files}")
        say("cli-train", f"train losses {out['train_losses']}, validation losses "
            f"{out['val_losses']}, std_scale {out.get('std_scale')}; launches {train_counts}; "
            f"plain versions called on the card {plain_train}")
        want_files = ["args.yaml", "data_processor.json", "metadata.json", "opt_state.pt",
                      "params.msgpack", "params.pt", "task_loader.pkl"]
        if files != want_files:
            raise AssertionError(f"the CLI wrote {files}, not {want_files}")
        losses = out["train_losses"] + out["val_losses"]
        if len(out["train_losses"]) != CLI_EPOCHS or not np.isfinite(losses).all():
            raise AssertionError(f"CLI training losses {losses}")
        lo, hi = STD_SCALE_RANGE
        if not lo <= out.get("std_scale", np.nan) <= hi:
            raise AssertionError(f"std_scale {out.get('std_scale')} outside [{lo}, {hi}]")
        if train_counts["encode_offgrid"] == 0 or train_counts["encode_offgrid_grad"] == 0:
            raise AssertionError(f"CLI training launched {train_counts}")

        t0 = time.perf_counter()
        run = load_run(str(run_dir))
        load_s = time.perf_counter() - t0
        tl = run["task_loader"]
        grid = f"{len(tl.x1g)}x{len(tl.x2g)}"
        model_dev = next(run["model"].parameters()).device
        if model_dev != dev or tl.internal_density != cfg.internal_density:
            raise AssertionError(f"load_run gave a model on {model_dev} and a loader at density "
                                 f"{tl.internal_density}")
        del run, tl
        t0 = time.perf_counter()
        svc = PredictService(str(run_dir), dem, highres_factor=2)
        svc_s = time.perf_counter() - t0
        loader = svc.run["task_loader"] = Timed(svc.run["task_loader"])
        forward = svc.predictor.predict_grid = Timed(svc.predictor.predict_grid,
                                                     cuda_events=True)
        times = base.coords["time"][:CLI_REQUEST_TIMES]
        req = [str(t) for t in times]
        setconv_cuda.reset_launch_counts()
        with plain_calls_on_card(setconv) as plain:
            resp, _, total_s = timed(lambda: svc.predict(req))
            serve_counts = setconv_cuda.launch_counts()
        direct = forward.fn(loader.calls[-1]["out"], svc.pred_grid,
                            aux_at_targets=loader.aux_at_targets, times=np.asarray(times))
        sea = np.isnan(svc.pred_grid.data)
        same = {}
        for key in ("mean", "std"):
            got = np.asarray(resp[key], np.float32)
            want = np.nan_to_num(direct[key].data, nan=-9999.0)
            same[key] = (got.shape == (len(req),) + svc.pred_grid.shape
                         and got.tobytes() == want.tobytes()
                         and bool(((got == -9999.0) == sea).all()))
        fwd = forward.calls[-1]
        say("cli-train", f"load_run {load_s:.3f} s (grid {grid}); PredictService {svc_s:.3f} s; "
            f"request ({len(req)} times, grid {svc.pred_grid.shape}) {total_s:.3f} s wall = "
            f"loader "
            f"{loader.calls[-1]['wall_s']:.4f} + predict_grid {fwd['wall_s']:.4f} s "
            f"({fwd['ms']:.1f} ms CUDA events) + response; launches {serve_counts}; plain "
            f"versions called on the card {dict(plain)}; bitwise equal to a direct "
            f"predict_grid with sea -9999: {same}; the phase "
            f"{time.perf_counter() - t_phase:.1f} s wall")
        if serve_counts["encode_offgrid"] != 1 or serve_counts["decode_grid"] != 1:
            raise AssertionError(f"the CLI run's request launched {serve_counts}")
        if not all(same.values()):
            raise AssertionError("the CLI run's response differs from predict_grid")
        if any(plain_train.values()) or any(plain.values()):
            raise AssertionError("a plain SetConv ran on the card in the CLI run")
        del svc
    return {k: train_counts[k] + serve_counts[k] for k in train_counts}


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import_port()
    from deepsensornz_tpu_torch.models.convnp import ConvNPConfig
    from deepsensornz_tpu_torch.infer.predict import Predictor
    from deepsensornz_tpu_torch.ops import _build, setconv, setconv_cuda

    # -- 1. device ---------------------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"count {torch.cuda.device_count()}")
    print(smi, flush=True)  # name, power limit, as nvidia-smi prints them
    say("device", f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    say("device", "; ".join(f"{m} {module_version(m)}" for m in
                            ("scipy", "pandas", "yaml", "matplotlib")))

    # -- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    say("build", f"{lib_path.name} in {time.perf_counter() - t0:.2f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("build", line.strip())
    tensor_ops = sass_tensor_ops(lib_path)
    for name, counts in tensor_ops.items():
        say("build", f"SASS {name}: {counts}")
    for name in KERNELS:
        if not any(v for k, c in tensor_ops.items() if name in k for v in c.values()):
            raise AssertionError(f"no HGMMA/HMMA instruction in {name}'s SASS")

    # -- 3. kernels against their plain versions -----------------------------------
    target_var = "temperature_station"
    dp = make_processor(target_var)
    dem, aux_field = target_fields(dp, TARGET_HW, seed=0)
    cfg = ConvNPConfig(unet_channels=(64, 64, 64, 64), likelihood="gnp",
                       internal_density=500, rank=64, decoder_channels=64,
                       mlp_hidden=64, kernel_size=5, compute_dtype="bfloat16")
    task0 = cycle_task(0, N_TASKS, cfg.internal_density)
    model = build_model(cfg, task0, seed=0, device=dev)
    results = kernel_checks(dev, model, dp, dem, task0)

    # -- 4. serve three 24-task requests ---------------------------------------------
    predictor = Predictor(model, dp, target_var)
    tasks = [cycle_task(seed, N_TASKS, cfg.internal_density)
             for seed in range(1, N_REQUESTS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    setconv_cuda.reset_launch_counts()
    request_ms, request_s = [], []
    for i, task in enumerate(tasks):
        pred, ms, wall = timed(lambda: predictor.predict_grid(task, dem, aux_at_targets=aux_field))
        request_ms.append(ms)
        request_s.append(wall)
        check_prediction(pred, dem, N_TASKS)
        land = ~np.isnan(dem.data)
        say("serve", f"request {i}: {request_ms[-1]:.1f} ms (CUDA events), "
            f"{request_s[-1]:.3f} s wall; mean {np.nanmean(pred['mean'].data[:, land]):.4f} "
            f"std {np.nanmean(pred['std'].data[:, land]):.4f}")
    serve_counts = setconv_cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    say("serve", f"p50 request {float(np.median(request_ms)):.1f} ms (CUDA events), "
        f"{float(np.median(request_s)):.3f} s wall; peak memory {peak / 2**30:.2f} GiB; "
        f"launches {serve_counts}")
    for name in ("encode_offgrid", "decode_grid"):
        if serve_counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the serving path")

    service_counts, b1_err = service_phase(dev, cfg, dp, target_var, setconv_cuda)
    results["encode_offgrid"]["max_abs_err"] = max(results["encode_offgrid"]["max_abs_err"],
                                                   b1_err)
    sample_counts = sample_serve(dev, model, dp, dem, aux_field, target_var, setconv_cuda)
    ar_counts = ar_phase(dev, model, dp, dem, aux_field, target_var, setconv_cuda)
    serve_reference(dev, dp, target_var)
    al_counts, al_err = al_phase(dev, model, setconv, setconv_cuda)
    results["encode_offgrid"]["max_abs_err"] = max(results["encode_offgrid"]["max_abs_err"],
                                                   al_err)
    t0 = time.perf_counter()
    al_reference(dev)
    say("al-reference", f"{time.perf_counter() - t0:.1f} s wall")

    results["encode_offgrid_grad"] = train_kernels(dev, model, setconv, setconv_cuda)
    train_counts = train_flagship(dev, model, cfg, setconv_cuda)
    pipeline_counts, pipeline_errs, validate_counts = pipeline_phase(dev, cfg, setconv,
                                                                     setconv_cuda)
    for name, err in pipeline_errs.items():
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    t0 = time.perf_counter()
    validate_reference(dev, setconv)
    say("validate-reference", f"{time.perf_counter() - t0:.1f} s wall")
    train_reference(dev, setconv_cuda)
    cli_counts = cli_train_phase(dev, cfg, setconv, setconv_cuda)

    phases = {"serve": serve_counts, "service": service_counts, "sample-serve": sample_counts,
              "ar": ar_counts, "al": al_counts, "train": train_counts,
              "pipeline": pipeline_counts, "validate": validate_counts, "cli-train": cli_counts}
    launches = {name: sum(c[name] for c in phases.values()) for name in KERNELS}
    say("launches", "; ".join(f"{k} {v}" for k, v in phases.items()))
    say("total", f"{time.perf_counter() - t_start:.1f} s wall, the kernels' build included")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name], **results[name]}
        for name in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
