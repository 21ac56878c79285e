"""Time B1's length-scale gradient (``encode_offgrid_grad``) on one NVIDIA GPU.

    python3 perf/torch_grad_bench.py [--root DIR]

``--root`` is the checkout whose ``deepsensornz_tpu_torch`` is imported and
built (default: the one holding this script), so two commits can be timed
in one call on one card: run it for each, in turns. The inputs and timers
are ``chip_smoke.py``'s (``grad_task``, ``cuda_ms``, ``kernel_device_ms``),
from the checkout holding this script: ``[train-kernels]``'s station sets
(uniform on the domain, or all in one 0.2 x 0.2 corner) on the 608x608
internal grid of density 500, the flagship model's initial station
length-scale 0.005 (2/500 plus the 0.5/500 floor) or 0.3 (every station
reaches every cell), a random upstream gradient and the forward kernel's
output.
Prints one JSON line: the card's name and power limit (``nvidia-smi``), the
package, and per shape: the median CUDA-event time of one wrapper call over
``REPS`` runs after a warm-up (host work included where the card waits for
it), the kernel's own device time per launch from ``torch.profiler``, the
host time per call with the calls queued back to back, and the result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
# label: (tasks, all stations in the corner, length-scale)
SHAPES = {"train 8x512": (8, False, 0.005), "serve 24x512": (24, False, 0.005),
          "corner 8x512": (8, True, 0.005), "l 0.3 8x512": (8, False, 0.3)}
DENSITY = 500
REPS = 20


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_grad_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    sys.path.insert(0, args.root)  # the package under test, ahead of HERE's
    import deepsensornz_tpu_torch
    from deepsensornz_tpu_torch.ops import setconv_cuda

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    out = {"card": smi, "package": str(Path(deepsensornz_tpu_torch.__file__).parent),
           "times_ms": {}, "kernel_ms": {}, "host_ms": {}, "values": {}}
    for label, (B, corner, lengthscale) in SHAPES.items():
        task = cs.grad_task(B, DENSITY, corner).to(dev)
        p = task.points[0]
        pts = (task.x1g, task.x2g, p.x, p.y, p.mask)
        ls = torch.tensor(lengthscale, device=dev)  # on the card, as the model's
        gen = torch.Generator(device=dev).manual_seed(B)
        g = torch.randn((B, len(task.x1g), len(task.x2g), 2), generator=gen, device=dev)
        with torch.no_grad():
            fwd = setconv_cuda.encode_offgrid(*pts, ls)
        call = lambda: setconv_cuda.encode_offgrid_grad(*pts, ls, g, fwd)  # noqa: E731
        out["values"][label] = float(call())
        out["times_ms"][label] = cs.cuda_ms(call, REPS)
        t0 = time.perf_counter()
        for _ in range(REPS):
            call()
        out["host_ms"][label] = 1e3 * (time.perf_counter() - t0) / REPS
        torch.cuda.synchronize()
        out["kernel_ms"][label] = cs.kernel_device_ms(call, "encode_offgrid_grad_kernel", REPS)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
