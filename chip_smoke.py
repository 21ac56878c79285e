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
             path). Median CUDA-event times of kernel and plain version,
             and TFLOP/s on the useful FLOPs.
4. serve   - the flagship ConvNP (U-Net (64,)*4, k=5, gnp rank 64, density
             500, bf16 U-Net, random weights from a seed) behind
             ``Predictor.predict_grid``: three requests of 24 tasks; checks
             the mean/std fields and that both kernels were launched.
5. reference - a small ConvNP on the GPU (kernels) against the same weights
             on the CPU (plain versions), through ``predict_grid``.
6. train-kernels - B1's length-scale backward against its plain version in
             float64, at the training shape (8x512 stations onto 608x608)
             and the serving shape (24x512), for a random upstream gradient,
             a density-only one and one positive on every channel; twice
             each (the result must not change from run to run). CUDA-event
             times of the kernel and of the plain f32 autograd backward.
7. train   - the flagship ConvNP's train step at ``perf/train_bench.py``'s
             shape (batch 8: the serving contexts plus 512 station targets
             with one aux channel; lr 5e-5): one warm-up step and 5 timed
             steps (CUDA events and wall, their median tasks/s), then one
             ``train_epoch`` over 5 batches timed as a whole (tasks over the
             window's wall time, synchronise to synchronise, host batching
             and uploads included); losses, peak memory; checks finite
             losses, moved parameters, and B1's forward and backward
             launched on every step.
8. train-reference - one train step of a small ConvNP on the GPU (kernels)
             and on the CPU (plain versions) from the same weights and
             batch: the loss, every parameter's gradient, and the update
             where Adam's first step is well conditioned.

The last two lines are a JSON object of per-kernel results and the
``{"ok": true, "device": {...}}`` line. Imports only the port, torch, numpy
and the standard library.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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


def train_task(seed: int, n_tasks: int, density: float, base_hw=(139, 130),
               aux_hw=TARGET_HW, n_stations: int = N_STATIONS, n_targets: int = N_TARGETS):
    """Training inputs (``perf/train_bench.py``'s shape): the serving
    cycle's context sets plus ``n_targets`` station targets per task, each
    with one aux channel."""
    import dataclasses

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


def train_kernels(dev, model, setconv, setconv_cuda) -> dict:
    """Phase 6: B1's backward against its plain version in float64 at the
    training and serving shapes; returns the training shape's numbers."""
    import torch

    ls = model.lengthscale("ls_points_0").detach()
    out = {}
    for label, n_tasks in (("train", N_TRAIN_TASKS), ("serve", N_TASKS)):
        task = cycle_task(10 + n_tasks, n_tasks, model.cfg.internal_density).to(dev)
        p = task.points[0]
        pts = (task.x1g, task.x2g, p.x, p.y, p.mask)
        gen = torch.Generator(device=dev).manual_seed(n_tasks)
        shape = (n_tasks, task.x1g.shape[0], task.x2g.shape[0], p.y.shape[-1] + 1)
        g_random = torch.randn(shape, generator=gen, device=dev)
        # the density channel alone: summands of one sign, nothing cancels
        g_density = torch.zeros(shape, device=dev)
        g_density[..., 0] = 0.5 + torch.rand(shape[:3], generator=gen, device=dev)
        # every channel positive: the value channels' terms without the
        # random sign's cancellation across cells
        g_positive = 0.5 + torch.rand(shape, generator=gen, device=dev)
        with torch.no_grad():  # the forward's output, as the backward gets it
            fwd = setconv_cuda.encode_offgrid(*pts, ls)
        max_err = 0.0
        for gname, g in (("random", g_random), ("density", g_density),
                         ("positive", g_positive)):
            got = setconv_cuda.encode_offgrid_grad(*pts, ls, g, fwd)
            again = setconv_cuda.encode_offgrid_grad(*pts, ls, g, fwd)
            terms = setconv.encode_offgrid_grad_ls_terms(*pts, ls.double(), g.double())
            ref = float(sum(t.sum() for t in terms))
            bound = GRAD_RTOL * abs(ref) + GRAD_SUM_TOL * float(sum(t.abs().sum() for t in terms))
            err = abs(float(got) - ref)
            max_err = max(max_err, err)
            say("train-kernels", f"{label} {shape} g {gname}: got {float(got):.9g} float64 "
                f"{ref:.9g}; abs err {err:.3e}, rel err {err / abs(ref):.3e}, bound "
                f"{GRAD_RTOL} * |ref| + {GRAD_SUM_TOL} * sum|terms| = {bound:.3e}; "
                f"deterministic {bool(torch.equal(got, again))}")
            if err > bound:
                raise AssertionError(f"encode_offgrid_grad disagrees with its plain version "
                                     f"({label}, g {gname})")
            if not torch.equal(got, again):
                raise AssertionError("encode_offgrid_grad changed from run to run")
        ms = cuda_ms(lambda: setconv_cuda.encode_offgrid_grad(*pts, ls, g_random, fwd))
        ls_req = ls.clone().requires_grad_(True)
        enc = setconv.setconv_encode_offgrid(*pts, ls_req)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(enc, ls_req, g_random, retain_graph=True))
        say("train-kernels", f"{label}: kernel {ms:.3f} ms, plain f32 autograd backward "
            f"{plain_ms:.3f} ms (CUDA events, median of {TIMING_REPS})")
        if label == "train":
            out = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}
        else:
            out["max_abs_err"] = max(out["max_abs_err"], max_err)
        del enc, fwd, terms, task
    return out


def train_flagship(dev, model, cfg, setconv_cuda) -> dict:
    """Phase 7: the flagship train step at perf/train_bench.py's shape;
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
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, loss = step(state, task, TRAIN_LR)
        end.record()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        step_ms.append(start.elapsed_time(end))
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


def train_reference(dev, setconv_cuda) -> None:
    """Phase 8: a small train step on the GPU (kernels) against the CPU
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import_port()
    from deepsensornz_tpu_torch.models.convnp import ConvNPConfig
    from deepsensornz_tpu_torch.ops import _build, setconv, setconv_cuda
    from deepsensornz_tpu_torch.infer.predict import Predictor

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
    results = {}
    with torch.inference_mode():
        task = task0.to(dev)
        p = task.points[0]
        enc_args = (task.x1g, task.x2g, p.x, p.y, p.mask, model.lengthscale("ls_points_0"))
        f = model.features(task)  # bf16, channel-first memory seen as NHWC
        xt1 = torch.from_numpy(dp.map_x1(dem.coords["latitude"]).astype(np.float32)).to(dev)
        xt2 = torch.from_numpy(dp.map_x2(dem.coords["longitude"]).astype(np.float32)).to(dev)
        ls_dec = model.lengthscale("ls_decoder")
        # the flagship path hands the U-Net's bf16 output to the decode; the
        # f32 path (f32 U-Net, hoisted head) is held at a smaller depth
        f4 = f[:F32_TASKS].float()
        B, H, W, C = f.shape
        Ht, Wt = TARGET_HW
        dec_flop = 2.0 * C * (Ht * H * W + Ht * W * Wt)  # per task, both contractions
        cases = {
            "encode_offgrid": (setconv_cuda.encode_offgrid, setconv.setconv_encode_offgrid,
                               enc_args, 2.0 * N_TASKS * H * W * N_STATIONS * (p.y.shape[-1] + 1)),
            "decode_grid": (setconv_cuda.decode_grid, setconv.setconv_decode_grid,
                            (task.x1g, task.x2g, f, xt1, xt2, ls_dec), N_TASKS * dec_flop),
            "decode_grid_f32": (setconv_cuda.decode_grid, setconv.setconv_decode_grid,
                                (task.x1g, task.x2g, f4, xt1, xt2, ls_dec), F32_TASKS * dec_flop),
        }
        for name, (kernel, plain, args, flop) in cases.items():
            got = kernel(*args)
            torch.cuda.synchronize()
            cmp = compare(got, plain(*args), RTOL, ATOL_FRAC)
            ms = cuda_ms(lambda: kernel(*args))
            plain_ms = cuda_ms(lambda: plain(*args))
            say("kernels", f"{name} {tuple(got.shape)}: max_abs_err {cmp['max_abs_err']:.3e} "
                f"max_rel_err {cmp['max_rel_err']:.3e} (rtol {RTOL}, atol {cmp['atol']:.3e}) "
                f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
                f"{flop / 1e9:.1f} GFLOP useful: kernel {flop / ms / 1e9:.1f} TFLOP/s, "
                f"plain {flop / plain_ms / 1e9:.1f} TFLOP/s")
            if not cmp["ok"]:
                raise AssertionError(f"{name} disagrees with its plain version")
            results[name] = {"max_abs_err": cmp["max_abs_err"], "ms": ms, "plain_ms": plain_ms}
        del f, f4, got, task

    # -- 4. serve three 24-task requests ---------------------------------------------
    predictor = Predictor(model, dp, target_var)
    tasks = [cycle_task(seed, N_TASKS, cfg.internal_density)
             for seed in range(1, N_REQUESTS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    setconv_cuda.reset_launch_counts()
    request_ms, request_s = [], []
    for i, task in enumerate(tasks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        pred = predictor.predict_grid(task, dem, aux_at_targets=aux_field)
        end.record()
        torch.cuda.synchronize()
        request_s.append(time.perf_counter() - t0)
        request_ms.append(start.elapsed_time(end))
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

    # -- 5. a small forward on the GPU against the CPU ---------------------------------
    small = ConvNPConfig(unet_channels=(8, 8), likelihood="gnp", internal_density=40,
                         rank=4, decoder_channels=8, mlp_hidden=8, compute_dtype="float32")
    sdem, saux = target_fields(dp, (30, 28), seed=1)
    stask = cycle_task(4, 3, small.internal_density, base_hw=(12, 11), aux_hw=(30, 28),
                       n_stations=40)
    gpu_model = build_model(small, stask, seed=1, device=dev)
    cpu_model = build_model(small, stask, seed=1, device="cpu")
    a = Predictor(gpu_model, dp, target_var).predict_grid(stask, sdem, aux_at_targets=saux)
    b = Predictor(cpu_model, dp, target_var).predict_grid(stask, sdem, aux_at_targets=saux)
    land = ~np.isnan(sdem.data)
    for key in ("mean", "std"):
        cmp = compare(torch.from_numpy(a[key].data[:, land]),
                      torch.from_numpy(b[key].data[:, land]), REF_RTOL, REF_ATOL_FRAC)
        say("reference", f"{key}: GPU vs CPU max_abs_err {cmp['max_abs_err']:.3e} "
            f"(rtol {REF_RTOL}, atol {cmp['atol']:.3e})")
        if not cmp["ok"]:
            raise AssertionError(f"small-model {key} on the GPU disagrees with the CPU")

    results["encode_offgrid_grad"] = train_kernels(dev, model, setconv, setconv_cuda)
    train_counts = train_flagship(dev, model, cfg, setconv_cuda)
    train_reference(dev, setconv_cuda)

    launches = {name: serve_counts[name] + train_counts[name] for name in KERNELS}
    say("launches", f"serve {serve_counts}, train {train_counts}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name], **results[name]}
        for name in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
