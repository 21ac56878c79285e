"""The control of the ``serve_month`` cells: the plain reference
(:mod:`benchmark.reference.convnp_spikes_beta`) put in the program's
place, its U-Net computed in float8 e4m3 (one scale a tensor; the
configuration states bfloat16), and compared with the bfloat16 reference
by the cell's own numbers.

    python3 benchmark/control_month.py --workload NAME --seeds N [N ...]

It runs the reference only, on the card, on the requests a run checks
(the first ``check_requests`` of the pool, each on the tasks drawn for
it), one JSON line a seed. The benchmark's runs never run it; its
readings set the upper end of each limit (PERF.md).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, device, prec: str = "fp8") -> dict:
    from benchmark.entries import serve_month

    dom, pool, weights = serve_month.serve_inputs(cell, seed, device)
    got, want = [], []
    for i in range(cell.traffic["check_requests"]):
        args = (cell, weights, dom, pool[i % len(pool)], serve_month.checked_tasks(cell, seed, i),
                device)
        got.append(serve_month.reference_maps(*args, prec=prec))
        want.append(serve_month.reference_maps(*args))
    return serve_month.numbers(got, want, cell.config["normalisation"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path[0] = str(ROOT)
    import torch

    from benchmark import manifest

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.resolve(args.workload, manifest.load_manifest(ROOT))
    for seed in args.seeds:
        t = time.perf_counter()
        out = readings(cell, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "variant": "fp8", "seed": seed,
                          "seconds": time.perf_counter() - t, "numbers": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
