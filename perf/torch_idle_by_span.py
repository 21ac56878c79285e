"""Where the card's idle time goes in the benchmark's cells, by the port's spans.

    python3 perf/torch_idle_by_span.py [--cells CELL ...] [--seed N] [--out DIR]

For each cell of ``BENCHMARK.json`` (default: all), builds the port's
model, inputs and ``Predictor`` or train step from the seed as the cell's
entry in ``benchmark/entries`` does, warms up, then runs the cell's traced
part (``trace_requests`` requests or ``trace_epochs`` epochs) twice: under
``perf.harness.profile_trace`` (host and card activity: each device
operation's launching thread is known) and under a card-only profiler (the
benchmark's own, whose host cost is lower). For each it prints one JSON
line: the card's name and power limit, the wall time of each request or
epoch, the recorder's snapshot per request or step, how much of the request's
span its children cover, and ``idle_by_span`` over every idle gap and over
the gaps of one kind: between a download and the next upload in serving
(``Memcpy DtoH -> Memcpy HtoD``), before each upload in training
(``-> Memcpy HtoD``). Needs CUDA; the traces go to a temporary directory,
or are kept under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _ms(d: dict) -> dict:
    return {k: round(1e3 * v, 3) for k, v in sorted(d.items(), key=lambda kv: -kv[1])}


def window(run_traced, profiler: str, out: Path, root: str, kind: tuple) -> dict:
    """Run the traced part under ``profiler`` ("host+card" or "card"); the
    spans, their coverage and the idle time by span."""
    import torch

    from deepsensornz_tpu_torch.perf import harness, spans

    spans.clear()
    torch.cuda.synchronize()
    path = out / profiler.replace("+", "_")
    path.mkdir(parents=True, exist_ok=True)
    if profiler == "card":
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            walls = run_traced()
        prof.export_chrome_trace(str(path / "trace.json"))
    else:
        with harness.profile_trace(str(path)):
            walls = run_traced()
    recs = spans.records()
    snap = spans.snapshot()
    roots = snap[root]["count"]
    per = {k: round(1e3 * v["total_s"] / roots, 3) for k, v in snap.items()}
    req = snap.get("predict_grid")
    cover = None if req is None else 1.0 - req["self_s"] / req["total_s"]
    gaps = harness.device_gaps(json.loads((path / "trace.json").read_text()))
    idle = harness.charge_gaps(gaps, recs)
    of_kind = harness.charge_gaps([g for g in gaps if kind[0] in g[3] and kind[1] in g[4]],
                                  recs)
    return {"profiler": profiler, "roots": roots, "wall_ms": [round(1e3 * w, 3) for w in walls],
            "median_wall_ms": round(1e3 * statistics.median(walls), 3),
            "ms_per_root": per, "children_cover": cover, "idle_ms": _ms(idle), "idle_total_ms": round(1e3 * sum(idle.values()), 3),
            f"idle_ms[{kind[0] or ''}->{kind[1]}]": _ms(of_kind),
            "kind_total_ms": round(1e3 * sum(of_kind.values()), 3)}


def serve_cell(cell, seed: int, dev):
    import numpy as np

    from benchmark.entries import common
    from deepsensornz_tpu_torch.data.grid import Field
    from deepsensornz_tpu_torch.data.processor import DataProcessor
    from deepsensornz_tpu_torch.infer.predict import Predictor

    cfg, tr = cell.config, cell.traffic
    dom, pool, weights = common.serve_inputs(cell, seed, dev)
    tasks = [common.task_batch(c, dom, with_targets=False) for c in pool]
    model = common.port_model(cell, weights, dev).eval()
    e = tr["extent"]
    dp = DataProcessor(x1_map=(e["minlat"], e["maxlat"]), x2_map=(e["minlon"], e["maxlon"]),
                       config={cfg["variable"]: cfg["normalisation"]})
    dem = Field(np.where(dom.land, 100.0, np.nan), ("latitude", "longitude"),
                {"latitude": dom.lat, "longitude": dom.lon}, "elevation")
    highres = Field(dom.highres, ("x1", "x2"), {"x1": dom.highres_x[0].astype(np.float64),
                                                "x2": dom.highres_x[1].astype(np.float64)},
                    "elevation")
    pr = tr["predictor"]
    p = Predictor(model, dp, cfg["variable"], std_scale=pr["std_scale"],
                  transfer_dtype=pr["transfer_dtype"], batch_chunk=pr["batch_chunk"],
                  download_threads=pr["download_threads"])

    def request(i):
        return p.predict_grid(tasks[i % len(tasks)], dem, aux_at_targets=highres,
                              n_samples=tr["n_samples"], seed=i, outputs=("mean", "std"))

    for i in range(tr["warmup_requests"]):
        request(-1 - i)

    def traced():
        walls = []
        for i in range(tr["trace_requests"]):
            t = time.perf_counter()
            request(i)
            walls.append(time.perf_counter() - t)
        return walls

    return traced, "predict_grid", ("DtoH", "HtoD")


def train_cell(cell, seed: int, dev):
    from benchmark import inputs
    from benchmark.entries import common
    from deepsensornz_tpu_torch.train.trainer import init_state, make_train_step, train_epoch

    tr = cell.traffic
    dom, pool, weights = common.train_inputs(cell, seed, dev)
    tasks = common.task_batch(pool, dom, with_targets=True)
    model = common.port_model(cell, weights, dev)
    step = make_train_step(model, weight_decay=tr["weight_decay"])
    box = {"state": init_state(model)}
    rng = inputs.rng_for(seed, common.SHUFFLE_STREAM)

    def epoch():
        box["state"], _ = train_epoch(model, box["state"], tasks, batch_size=tr["batch_size"],
                                      lr=tr["lr"], step_fn=step, rng=rng)

    epoch()

    def traced():
        walls = []
        for _ in range(tr["trace_epochs"]):
            t = time.perf_counter()
            epoch()
            walls.append(time.perf_counter() - t)
        return walls

    return traced, "train.launch", ("", "HtoD")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="*")
    ap.add_argument("--seed", type=int, default=2**31 + 1515)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    from benchmark import manifest
    from deepsensornz_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    _build.load_library()
    man = manifest.load_manifest(REPO)
    names = args.cells or [w["name"] for w in man["workloads"]]
    dev = torch.device("cuda", 0)
    threads = torch.get_num_threads()
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            one_cell(manifest.resolve(name, man), args.seed, dev, Path(args.out or tmp) / name,
                     threads)
    return 0


def one_cell(cell, seed: int, dev, out: Path, threads: int) -> None:
    """Both traced windows of one cell, each a JSON line; the cell's mix
    sets the host's intra-op threads as the benchmark's runner does."""
    import torch

    torch.set_num_threads(int(cell.traffic.get("host_threads", threads)))
    build = serve_cell if cell.traffic["entry"] == "serve" else train_cell
    traced, root, kind = build(cell, seed, dev)
    for profiler in ("host+card", "card"):
        got = window(traced, profiler, out, root, kind)
        print(json.dumps({"cell": cell.name, "card": card(), "seed": seed, **got}), flush=True)
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
