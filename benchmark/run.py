"""Run one cell of the benchmark of ``deepsensornz_tpu_torch`` on the card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Set-up (imports, CUDA context, the kernels'
build on a checkout's first run and their load, inputs, weights, warm-up)
is timed from this file's first line to the window's start. With
``--trace 0`` the last line of standard output is the result object with
the cell's end-to-end metrics, with ``--trace 1`` with its per-layer
metrics; the numbers that decide ``correct`` come last in it, under
``check``, and on standard error beside their limits. Without a card, or
with fewer cards than the cell asks for, or with JAX or the JAX package
loaded once the window has closed, it prints no result and exits 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def card_line() -> str:
    """The card's name, power limit, clocks and temperature now."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    sys.path[0] = str(ROOT)
    from benchmark import core, manifest

    cell = manifest.resolve(args.workload, manifest.load_manifest(ROOT))
    import torch

    if "host_threads" in cell.traffic:  # the mix fixes the process's intra-op threads
        torch.set_num_threads(int(cell.traffic["host_threads"]))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from deepsensornz_tpu_torch.ops import _build

    built = _build.library_path().is_file()
    t = time.perf_counter()
    _build.load_library()
    print(f"kernels: {'loaded the library built before' if built else 'built'} "
          f"{_build.library_path().name} in {time.perf_counter() - t:.3f} s", file=sys.stderr)
    result, lines = core.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                  torch.device("cuda", 0), T0)
    found = manifest.forbidden_loaded(list(sys.modules))
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    print(f"card: {card_line()}; seed {args.seed}; trace {args.trace}; "
          f"pid {os.getpid()}", flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
