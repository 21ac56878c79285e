"""Entry ``serve``: a closed loop of one client calling
``Predictor.predict_grid`` on forecast cycles, set as ``PredictService``
sets it (the transfer dtype, chunk, download threads and ``std_scale`` of
the traffic file).

Set-up makes the inputs and the weights from the seed, builds the port's
model and ``Predictor`` and sends ``warmup_requests`` requests. The window
sends request i (cycle i mod ``pool`` of the pool, sample seed i) as soon
as request i-1 has returned its host maps, until ``--seconds`` have
passed; each request's wall time counts. With ``--trace 1`` the first
``trace_requests`` requests run under the profiler. After the window a
sample of the finished requests, drawn from the seed among those whose
maps were kept (each with probability ``keep_share``, decided from the
seed before the window), is compared with the plain reference.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import check, inputs, work
from benchmark.entries import common
from benchmark.reference import convnp as ref
from benchmark.trace import Tracer, warm_profiler


def _work(cell, dom, pool, weights, n_traced: int) -> dict:
    """Model FLOPs and the SetConv kernels' bounds over the traced requests."""
    m, tr = cell.config["model"], cell.traffic
    dens = m["internal_density"]
    H, W = len(dom.x1g), len(dom.x2g)
    Ht, Wt = dom.land.shape
    B = tr["tasks_per_request"]
    cin = common.GRID_CHANNELS + 1 + tr["aux_channels"] + 1 + common.POINT_CHANNELS + 1
    per_task = (work.unet_flops(H, W, cin, m["unet_channels"], m["kernel_size"],
                                m["decoder_channels"])
                + work.mlp_flops(Ht * Wt, [m["decoder_channels"] + common.AUX_AT_TARGETS]
                                 + [m["mlp_hidden"]] * m["mlp_layers"] + [ref.n_outputs(m)]))
    ls_p = common.lengthscale(weights, "ls_points_0", dens)
    ls_d = common.lengthscale(weights, "ls_decoder", dens)
    b2f, b2b = work.decode_grid_work(dom.x1g, dom.x2g, dom.xt1, dom.xt2, ls_d, B,
                                     m["decoder_channels"], 2 if m["compute_dtype"] == "bfloat16"
                                     else 4)
    b1 = []
    for cyc in pool:
        fb = [work.encode_work(dom.x1g, dom.x2g, x, mk, common.POINT_CHANNELS, ls_p)
              for x, mk in zip(cyc["st_x"], cyc["st_mask"])]
        b1.append((sum(f for f, _ in fb), sum(b for _, b in fb) + 4.0 * (H + W)))
    flops = b1_bound = 0.0
    for i in range(n_traced):
        f1, by1 = b1[i % len(pool)]
        flops += B * per_task + f1 + b2f
        b1_bound += work.card_bound_s(f1, by1)
    return {"model_flops": flops, "b1": (b1_bound, n_traced),
            "b2": (n_traced * work.card_bound_s(b2f, b2b), n_traced)}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> common.Outcome:
    import torch

    from deepsensornz_tpu_torch.data.grid import Field
    from deepsensornz_tpu_torch.data.processor import DataProcessor
    from deepsensornz_tpu_torch.infer.predict import Predictor

    cfg, tr = cell.config, cell.traffic
    m = cfg["model"]
    dom, pool, weights = common.serve_inputs(cell, seed, device)
    tasks = [common.task_batch(c, dom, with_targets=False) for c in pool]
    model = common.port_model(cell, weights, device).eval()
    e = tr["extent"]
    dp = DataProcessor(x1_map=(e["minlat"], e["maxlat"]), x2_map=(e["minlon"], e["maxlon"]),
                       config={cfg["variable"]: cfg["normalisation"]})
    elev = np.where(dom.land, 100.0, np.nan)
    dem = Field(elev, ("latitude", "longitude"), {"latitude": dom.lat, "longitude": dom.lon},
                "elevation")
    highres = Field(dom.highres, ("x1", "x2"), {"x1": dom.highres_x[0].astype(np.float64),
                                                "x2": dom.highres_x[1].astype(np.float64)},
                    "elevation")
    pr = tr["predictor"]
    predictor = Predictor(model, dp, cfg["variable"], std_scale=pr["std_scale"],
                          transfer_dtype=pr["transfer_dtype"], batch_chunk=pr["batch_chunk"],
                          download_threads=pr["download_threads"])
    n_samples = tr["n_samples"]

    def request(i: int):
        return predictor.predict_grid(tasks[i % len(tasks)], dem, aux_at_targets=highres,
                                      n_samples=n_samples, seed=i, outputs=("mean", "std"))

    for i in range(tr["warmup_requests"]):
        request(-1 - i)
    if trace:
        warm_profiler()
    torch.cuda.synchronize(device) if device.type == "cuda" else None
    setup_s = time.perf_counter() - t0

    keep = inputs.rng_for(seed, 3).random(1 << 20) < tr["keep_share"]
    kept, lat, last = {}, [], {}
    n_traced = tr["trace_requests"] if trace else 0
    tracer = Tracer(trace)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    w0 = time.perf_counter()

    def one(i: int):
        t = time.perf_counter()
        pred = request(i)
        lat.append(time.perf_counter() - t)
        if keep[i % len(keep)]:
            kept[i] = pred
        last.clear()
        last[i] = pred

    with tracer:
        for i in range(n_traced):
            one(i)
    traced_s = tracer.window_s
    i = n_traced
    while time.perf_counter() - w0 < seconds:
        one(i)
        i += 1
    window_s = time.perf_counter() - w0
    n = len(lat)
    B = tr["tasks_per_request"]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    notes = {"requests": n, "window_s": window_s, "median_request_ms": 1e3 * float(np.median(lat))}
    readings = None
    if trace:
        notes["traced_tasks_per_s"] = n_traced * B / traced_s
        if n > n_traced:
            notes["untraced_tasks_per_s"] = (n - n_traced) * B / (window_s - traced_s)
        readings = common.Readings(trace=tracer.finish(), tasks=n_traced * B,
                                   work=_work(cell, dom, pool, weights, n_traced),
                                   peak_bytes=peak)
    e2e = {"serve_tasks_per_s": n * B / window_s, "serve_ms_p95": 1e3 * float(np.percentile(lat, 95)),
           "setup_s": setup_s}

    # the check: the program's state freed, then the reference
    del predictor, model, tasks
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    kept = kept or last  # a window too short to keep any: the last request's maps
    rng = inputs.rng_for(seed, 6)
    chosen = sorted(rng.choice(sorted(kept), min(tr["check_requests"], len(kept)), replace=False))
    got, want = [], []
    for i in chosen:
        pred = kept[i]
        g = {"mean": pred["mean"].data, "std": pred["std"].data}
        if n_samples:
            g["samples"] = pred["samples"].data
        got.append(g)
        want.append(ref.serve_maps(weights, m, pool[i % len(pool)], dom, cfg["normalisation"],
                                   pr["std_scale"], device, n_samples=n_samples, seed=i))
    numbers = check.serve_numbers(got, want)
    notes["checked_requests"] = [int(i) for i in chosen]
    return common.Outcome(attempted=n, failed=0, e2e=e2e, numbers=numbers, peak_bytes=peak,
                          readings=readings, notes=notes)
