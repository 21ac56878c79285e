"""Where the time of the port's probabilistic serving goes, on one NVIDIA GPU.

    python3 perf/torch_sample_profile.py

At chip_smoke.py's flagship width (U-Net (64,)*4, gnp rank 64, 608x608
internal grid, 278x260 output, 24 tasks, random weights from a seed), after
a warm-up of each call:

- one ``predict_grid`` request without samples and one with 4 joint
  samples, each under ``torch.profiler``: wall time, the device's kernel
  and copy time (its busy share of the wall), the top kernels, and the
  host-clock split of the request into ``Predictor._forward`` (upload,
  forward, sampling, land gather, download, scatter into NaN maps) and
  the rest (unnormalisation, ``Field`` assembly);
- one ``ar_sample`` at ``perf/ar_bench.py``'s shape (24 tasks x 512
  targets, 8 blocks, one sample) and one ``ar_sample_grid`` of 4 tasks
  (278x260 grid, subsample 4), each under the profiler;
- a month of hourly tasks (720) in one ``predict_grid`` call with
  ``batch_chunk=24``, without the profiler: wall time, tasks/s and the
  peak device memory, which the chunk bounds (one 720-task batch would not
  fit on the card).

Prints one line per measurement, each with the card's name and power
limit. Needs CUDA; imports only the port, torch, numpy and the synthetic
inputs of chip_smoke.py.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
N_SAMPLES = 4
TOP = 12
MONTH_TASKS = 720  # a month of hourly tasks


def profile(fn, label: str, card: str):
    """Run ``fn`` once under the profiler; print its wall time, the device
    time by kind and the top kernels. Returns fn's result."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, copies, memsets): the operator rows
    # that launched them carry the same time again
    rows = [e for e in prof.key_averages()
            if "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
    if not rows:
        raise RuntimeError("the profiler saw no device activity")
    total = sum(e.self_device_time_total for e in rows) / 1e3
    copies = sum(e.self_device_time_total for e in rows if "Memcpy" in e.key) / 1e3
    print(f"[{label}] {card}: wall {1e3 * wall:.1f} ms; device {total:.1f} ms "
          f"({100 * total / (1e3 * wall):.1f} % busy), of which copies {copies:.1f} ms; "
          f"host-only {1e3 * wall - total:.1f} ms", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"[{label}]   {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<4d} "
              f"{e.key[:110]}", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_sample_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from deepsensornz_tpu_torch.infer.ar import ar_sample
    from deepsensornz_tpu_torch.infer.predict import Predictor
    from deepsensornz_tpu_torch.models.convnp import ConvNPConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dp = cs.make_processor("temperature_station")
    dem, aux = cs.target_fields(dp, cs.TARGET_HW, seed=0)
    cfg = ConvNPConfig(unet_channels=(64, 64, 64, 64), likelihood="gnp", internal_density=500,
                       rank=64, decoder_channels=64, mlp_hidden=64, kernel_size=5,
                       compute_dtype="bfloat16")
    task = cs.cycle_task(1, cs.N_TASKS, cfg.internal_density)
    model = cs.build_model(cfg, task, seed=0, device=dev)

    class Split(Predictor):
        """Host-clock split of predict_grid: _forward against the rest."""

        def _forward(self, *args, **kw):
            t0 = time.perf_counter()
            out = super()._forward(*args, **kw)
            self.forward_s = time.perf_counter() - t0
            return out

    pred = Split(model, dp, "temperature_station")
    for n in (0, N_SAMPLES):
        def call():
            return pred.predict_grid(task, dem, aux_at_targets=aux, n_samples=n, seed=1)

        call()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        wall = time.perf_counter() - t0
        print(f"[request n_samples={n}] {card}: host clock {1e3 * wall:.1f} ms = _forward "
              f"{1e3 * pred.forward_s:.1f} ms + after it {1e3 * (wall - pred.forward_s):.1f} ms",
              flush=True)
        profile(call, f"request n_samples={n}", card)

    ar_task = cs.train_task(40, cs.N_TASKS, cfg.internal_density)
    gen = torch.Generator(device=dev)

    def ar_call():
        gen.manual_seed(0)
        return ar_sample(model, ar_task, n_samples=1, n_blocks=cs.AR_BLOCKS, generator=gen)

    ar_call()
    profile(ar_call, "ar_sample 24x512, 8 blocks", card)
    grid_task = cs.cycle_task(41, cs.AR_GRID_TASKS, cfg.internal_density)

    def grid_call():
        return pred.ar_sample_grid(grid_task, dem, aux_at_targets=aux,
                                   subsample_factor=cs.AR_SUBSAMPLE, n_blocks=cs.AR_BLOCKS)

    grid_call()
    out = profile(grid_call, "ar_sample_grid 4 tasks, 278x260, subsample 4", card)
    land = ~np.isnan(dem.data)
    if not np.isfinite(out[..., land]).all():
        raise AssertionError("ar_sample_grid not finite on land")

    month = cs.cycle_task(50, MONTH_TASKS, cfg.internal_density)
    chunked = Predictor(model, dp, "temperature_station", batch_chunk=cs.N_TASKS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pred = chunked.predict_grid(month, dem, aux_at_targets=aux)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    if not np.isfinite(pred["mean"].data[:, land]).all():
        raise AssertionError("month mean not finite on land")
    print(f"[month {MONTH_TASKS} tasks, batch_chunk={cs.N_TASKS}] {card}: wall {wall:.2f} s, "
          f"{MONTH_TASKS / wall:.1f} tasks/s, peak memory {peak / 2**30:.2f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
