"""Device health check CLI: the compile, dispatch and transfer legs.

Counterpart of ``deepsensornz_tpu/cli/health.py``, with its report keys,
flags, budgets and exit codes. An operator deciding whether to start a
training run or a month of inference on a card asks which of three legs
is sick:

- **compile**: on the card, building and loading the SetConv CUDA kernels
  (``ops._build.build`` and ``load_library``: ``nvcc`` when no library for
  these sources exists yet) and the first launch of a tiny station encode
  (B1), synchronised by a 4-byte fetch; on the CPU (``--device cpu``), the
  first call of the same tiny program (the encode's plain version);
- **dispatch**: the median round trip of that launched program with a
  4-byte synchronising fetch per call;
- **transfer**: ``--transfer_mb`` of float32 each way through pageable
  memory: the upload timed to a fetch of a value that depends on it, then
  the download.

    python -m deepsensornz_tpu_torch.cli.health            # all three legs
    python -m deepsensornz_tpu_torch.cli.health --quick    # skip the transfer leg
    python -m deepsensornz_tpu_torch.cli.health --device cpu

It runs on the card unless ``--device cpu`` is given, and raises when no
card is found rather than measuring the CPU. Prints ONE JSON line; exits 1
if a measured leg breaches its ``--max_*``/``--min_*`` budget (the
defaults fail only a genuinely sick leg).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# the tiny program: 16 stations onto a 64x64 grid
_GRID, _POINTS = 64, 16


def _tiny_encode(dev: torch.device):
    """The tiny program and its inputs on ``dev``: the station encode (B1
    on the card, its plain version on the CPU) with a 4-byte fetch."""
    from deepsensornz_tpu_torch.ops.setconv_cuda import encode_offgrid

    g = torch.Generator().manual_seed(0)
    x1g = torch.linspace(0.0, 1.0, _GRID).to(dev)
    x = torch.rand((1, _POINTS, 2), generator=g).to(dev)
    y = torch.randn((1, _POINTS, 1), generator=g).to(dev)
    mask = torch.ones((1, _POINTS)).to(dev)

    def run() -> float:
        with torch.no_grad():
            return float(encode_offgrid(x1g, x1g, x, y, mask, 0.05)[0, 0, 0, 0])

    return run


def run_health(quick: bool = False, reps: int = 5, transfer_mb: float = 4.0,
               device=None) -> dict:
    """Measure the compile, dispatch and transfer legs on ``device`` (None:
    the card, which must exist); returns the report."""
    from deepsensornz_tpu_torch.pipeline.validate import resolve_device

    dev = resolve_device(device)
    report = {}
    if dev.type == "cuda":
        report["platform"] = "gpu"
        report["device"] = torch.cuda.get_device_name(dev)
        report["n_devices"] = torch.cuda.device_count()
    else:
        report["platform"] = dev.type
        report["device"] = str(dev)
        report["n_devices"] = 1

    # --- compile leg (also warms the program the dispatch leg reuses) ---
    t0 = time.perf_counter()
    if dev.type == "cuda":
        from deepsensornz_tpu_torch.ops import _build

        _build.build()
        _build.load_library()
    run = _tiny_encode(dev)
    run()  # the 4-byte fetch waits for the launch
    report["compile_s"] = round(time.perf_counter() - t0, 3)

    # --- dispatch leg: the launched program, a 4-byte fetch per call ---
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    report["dispatch_ms_p50"] = round(float(np.median(times)) * 1e3, 2)

    if not quick:
        # --- transfer leg: transfer_mb each way, f32, pageable host memory ---
        n = int(transfer_mb * 1e6 / 4)
        host = np.ones((n,), np.float32)
        t0 = time.perf_counter()
        on_dev = torch.from_numpy(host).to(dev)
        float(on_dev[:8].sum())  # a value that depends on the upload
        up_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = on_dev.cpu().numpy()
        down_s = time.perf_counter() - t0
        if back.shape != host.shape:
            raise RuntimeError(f"download came back {back.shape}, sent {host.shape}")
        report["upload_mb_s"] = round(transfer_mb / up_s, 2)
        report["download_mb_s"] = round(transfer_mb / down_s, 2)

    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="skip the transfer leg")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--transfer_mb", type=float, default=4.0)
    ap.add_argument("--max_compile_s", type=float, default=300.0,
                    help="fail (exit 1) if the compile leg exceeds this")
    ap.add_argument("--max_dispatch_ms", type=float, default=1000.0)
    ap.add_argument("--min_transfer_mb_s", type=float, default=0.5)
    ap.add_argument("--device", default=None,
                    help="the device to check (default: the card; 'cpu' for the CPU)")
    ns = ap.parse_args(argv)

    report = run_health(quick=ns.quick, reps=ns.reps, transfer_mb=ns.transfer_mb,
                        device=ns.device)

    failures = []
    if report["compile_s"] > ns.max_compile_s:
        failures.append("compile")
    if report["dispatch_ms_p50"] > ns.max_dispatch_ms:
        failures.append("dispatch")
    if "download_mb_s" in report and (
        report["upload_mb_s"] < ns.min_transfer_mb_s
        or report["download_mb_s"] < ns.min_transfer_mb_s
    ):
        failures.append("transfer")
    report["healthy"] = not failures
    if failures:
        report["failed_legs"] = failures

    print(json.dumps(report))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
