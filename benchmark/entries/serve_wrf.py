"""Entry ``serve_wrf``: the ``serve`` loop on a 24-hour WRF cycle at the
0.01° grid, with the ``cnp`` head and its reference
(:mod:`benchmark.reference.convnp_cnp`).

A closed loop of one client calling ``Predictor.predict_grid`` as
``PredictService`` sets it (the traffic file's transfer dtype, chunk,
download threads and ``std_scale``). Set-up makes the inputs and the
weights from the seed, builds the port's model and ``Predictor`` and sends
``warmup_requests`` requests. The window sends request i (cycle i mod
``pool``) as soon as request i-1 has returned its host maps, until
``--seconds`` have passed; with ``--trace 1`` the first
``trace_requests`` run under the profiler. After the window,
``check_requests`` of the kept requests (each kept with probability
``keep_share``, decided from the seed before the window) are compared with
the reference, each on ``check_tasks`` of its tasks drawn from the seed,
over the whole grid: the reference computes the 0.01° grid in blocks, a
few tasks at a time.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import check, inputs, work
from benchmark.entries import common
from benchmark.reference import convnp as ref
from benchmark.reference import convnp_cnp
from benchmark.trace import Tracer, warm_profiler

CHECK_TASKS_STREAM = 7  # the stream of ``inputs.rng_for`` that draws a checked request's tasks


def spec_for(cell) -> dict:
    return convnp_cnp.param_spec(cell.config["model"],
                                 [common.GRID_CHANNELS, cell.traffic["aux_channels"]],
                                 [common.POINT_CHANNELS], common.AUX_AT_TARGETS)


def density(dom, x: tuple, ls: float) -> float:
    """A gridded context's density channel inside the domain: the median
    over the internal grid of the sum of its RBF weights over the context's
    cells (separable: the product of the two axes' sums)."""
    def axis(g, c):
        d = (g[:, None].astype(np.float64) - c[None, :].astype(np.float64)) / ls
        return np.exp(-0.5 * d * d).sum(1)

    return float(np.median(np.outer(axis(dom.x1g, x[0]), axis(dom.x2g, x[1]))))


def wrf_weights(cell, dom, seed: int, device) -> dict:
    """The benchmark's random weights from the seed (``ref.weights_from``),
    with the U-Net stem's kernel on each gridded context's density channel
    divided by that channel's value: on the 0.01° grids a context's density
    is ~300 (ℓ over the cell spacing, squared, times 2π), which random
    weights would carry through the U-Net into maps of hundreds of °C whose
    std collapses to 0 on most cells; a trained model's first layer takes
    that near-constant channel at its scale. Both sides get these weights."""
    m = cell.config["model"]
    w = ref.weights_from(spec_for(cell), m, seed, device)
    col = 0
    for i, x in enumerate((dom.base_x, dom.aux_x)):
        ls = common.lengthscale(w, f"ls_grid_{i}", m["internal_density"])
        w["unet.stem.weight"][:, col] /= density(dom, x, ls)
        col += 1 + (common.GRID_CHANNELS if i == 0 else cell.traffic["aux_channels"])
    return w


def serve_inputs(cell, seed: int, device) -> tuple:
    """(domain, pool of cycles, weights) of the cell from the seed."""
    dom = inputs.domain(cell.traffic, cell.config["model"], seed)
    pool = [inputs.serve_cycle(seed, k, dom, cell.traffic, cell.config["values"])
            for k in range(cell.traffic["pool"])]
    return dom, pool, wrf_weights(cell, dom, seed, device)


def checked_tasks(cell, seed: int, request: int) -> np.ndarray:
    """The tasks of ``request`` the check compares, drawn from the seed."""
    B = cell.traffic["tasks_per_request"]
    rng = inputs.rng_for(seed, CHECK_TASKS_STREAM, request)
    return np.sort(rng.choice(B, min(cell.traffic["check_tasks"], B), replace=False))


def reference_maps(cell, weights, dom, cycle: dict, tasks, device, prec=None) -> dict:
    cfg = cell.config
    return convnp_cnp.serve_maps(weights, cfg["model"], inputs.take(cycle, tasks), dom,
                                 cfg["normalisation"], cell.traffic["predictor"]["std_scale"],
                                 device, prec=prec)


def _work(cell, dom, pool, weights, n_traced: int) -> dict:
    """Model FLOPs and the SetConv kernels' bounds over the traced requests:
    the U-Net, the MLP head, B1 and B2 as ``serve`` counts them, and the
    two gridded encodes at what their inputs need (each a separable
    resample of a 1390×1300 context onto the internal grid, counted as
    ``work.decode_grid_work`` counts B2's: the nonzero weights only, the
    cheaper order)."""
    m, tr = cell.config["model"], cell.traffic
    dens = m["internal_density"]
    H, W = len(dom.x1g), len(dom.x2g)
    Ht, Wt = dom.land.shape
    B = tr["tasks_per_request"]
    cin = common.GRID_CHANNELS + 1 + tr["aux_channels"] + 1 + common.POINT_CHANNELS + 1
    per_task = (work.unet_flops(H, W, cin, m["unet_channels"], m["kernel_size"],
                                m["decoder_channels"])
                + work.mlp_flops(Ht * Wt, [m["decoder_channels"] + common.AUX_AT_TARGETS]
                                 + [m["mlp_hidden"]] * m["mlp_layers"]
                                 + [convnp_cnp.n_outputs(m)]))
    enc = 0.0
    for i, (x, c) in enumerate(((dom.base_x, common.GRID_CHANNELS),
                                (dom.aux_x, tr["aux_channels"]))):
        ls = common.lengthscale(weights, f"ls_grid_{i}", dens)
        enc += work.decode_grid_work(x[0], x[1], dom.x1g, dom.x2g, ls, B, c + 1, 4)[0]
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
        flops += B * per_task + enc + f1 + b2f
        b1_bound += work.card_bound_s(f1, by1)
    return {"model_flops": flops, "b1": (b1_bound, n_traced),
            "b2": (n_traced * work.card_bound_s(b2f, b2b), n_traced)}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> common.Outcome:
    import torch

    from deepsensornz_tpu_torch.data.grid import Field
    from deepsensornz_tpu_torch.data.processor import DataProcessor
    from deepsensornz_tpu_torch.infer.predict import Predictor

    cfg, tr = cell.config, cell.traffic
    dom, pool, weights = serve_inputs(cell, seed, device)
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

    def request(i: int):
        return predictor.predict_grid(tasks[i % len(tasks)], dem, aux_at_targets=highres,
                                      n_samples=tr["n_samples"], seed=i, outputs=("mean", "std"))

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
    host0 = common.host_counters()
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
    host = common.counters_over(host0, common.host_counters())
    n = len(lat)
    B = tr["tasks_per_request"]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    q = 1e3 * np.quantile(lat, [0.0, 0.5, 1.0])
    notes = {"requests": n, "window_s": window_s, "median_request_ms": float(q[1]),
             "request_ms_min_median_max": [float(v) for v in q],
             "requests_over_1.2x_median": int(sum(v > 1.2e-3 * q[1] for v in lat)),
             "host_over_window": host}
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
    got, want, checked = [], [], {}
    for i in chosen:
        idx = checked_tasks(cell, seed, i)
        pred = kept.pop(i)
        got.append({"mean": pred["mean"].data[idx], "std": pred["std"].data[idx]})
        want.append(reference_maps(cell, weights, dom, pool[i % len(pool)], idx, device))
        checked[int(i)] = [int(b) for b in idx]
    numbers = check.serve_numbers(got, want)
    notes["checked_requests"] = checked
    return common.Outcome(attempted=n, failed=0, e2e=e2e, numbers=numbers, peak_bytes=peak,
                          readings=readings, notes=notes)
