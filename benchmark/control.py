"""The control, and the planted faults, of the comparison that decides
``correct``: the plain reference put in the program's place, computed in
the precision below the configuration's, or with a fault planted, and
compared with the float32 reference by the cell's own numbers.

    python3 benchmark/control.py --workload NAME --seeds N [N ...] [--variant fp8|half_batch]

``fp8`` (the control): the U-Net's convolutions on float8 e4m3 inputs
and weights (e5m2 gradients), one scale a tensor; the configuration
states bfloat16. ``half_batch`` (a training cell's fault): each step's
loss over the first half of its batch. It runs the reference only, on the
card, on the requests (serving: the first ``check_requests`` of the pool,
with their sample seeds) or steps (training) a run checks, one JSON line a
seed. The benchmark's runs never run it; its readings set the upper end of
each limit (PERF.md).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def serve_readings(cell, seed: int, device, prec: str = "fp8") -> dict:
    from benchmark import check
    from benchmark.entries import common
    from benchmark.reference import convnp as ref

    dom, pool, weights = common.serve_inputs(cell, seed, device)
    tr, cfg = cell.traffic, cell.config
    got, want = [], []
    for i in range(tr["check_requests"]):
        kw = dict(n_samples=tr["n_samples"], seed=i)
        args = (weights, cfg["model"], pool[i % len(pool)], dom, cfg["normalisation"],
                tr["predictor"]["std_scale"], device)
        got.append(ref.serve_maps(*args, prec=prec, **kw))
        want.append(ref.serve_maps(*args, **kw))
    return check.serve_numbers(got, want)


def train_readings(cell, seed: int, device, variant: str = "fp8") -> dict:
    from benchmark import check
    from benchmark.entries import common
    from benchmark.reference import convnp as ref

    dom, pool, weights = common.train_inputs(cell, seed, device)
    m, lr = cell.config["model"], cell.traffic["lr"]
    batches = common.first_batches(cell, pool, seed)
    want = ref.train_steps(weights, m, batches, dom, lr, device)
    got = ref.train_steps(weights, m, batches, dom, lr, device,
                          prec="fp8" if variant == "fp8" else None,
                          half_batch=variant == "half_batch")
    got = {"losses": got["losses"], **ref.grad_and_update_norms(got, weights)}
    want = {"losses": want["losses"], **ref.grad_and_update_norms(want, weights)}
    return {**check.train_numbers(got, want), "diagnostics": check.train_diagnostics(got, want)}


def readings(cell, seed: int, device, variant: str) -> dict:
    if cell.traffic["entry"] == "serve":
        if variant != "fp8":
            raise ValueError(f"a serving cell has no {variant!r} variant")
        return serve_readings(cell, seed, device)
    return train_readings(cell, seed, device, variant)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variant", choices=("fp8", "half_batch"), default="fp8")
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
        out = readings(cell, seed, torch.device("cuda", 0), args.variant)
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          "seconds": time.perf_counter() - t, "numbers": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
