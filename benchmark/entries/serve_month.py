"""Entry ``serve_month``: the ``serve`` loop on a month of hourly humidity
tasks a request, as ``cli.infer`` sends one to ``ValidateERA.predict``,
with the ``cnp-spikes-beta`` head and its reference
(:mod:`benchmark.reference.convnp_spikes_beta`).

A closed loop of one client calling ``Predictor.predict_grid`` with the
traffic file's predictor (transfer dtype, ``batch_chunk``, upload dtype,
download threads, ``std_scale``), the ``post_transform`` it names and its
``outputs`` (the mean alone): a request of ``tasks_per_request`` tasks is
``tasks_per_request / batch_chunk`` chunks. Set-up makes the inputs and
the weights from the seed: ``pool`` months of tasks, each site absent with
probability ``station_absent``, the station and base values humidity in
model space (:func:`values`, the configuration's ``values``) and the base's
day-of-year channels each task's day; it builds the port's model and
``Predictor`` and sends ``warmup_requests`` requests. The window sends
request i (month i mod ``pool``) as soon as request i-1 has returned its
maps, until ``--seconds`` have passed; with ``--trace 1`` the first
``trace_requests`` run under the profiler. A request is kept with
probability ``keep_share`` (decided from the seed before the window): the
rows of the tasks its check would compare are copied and the rest is
dropped with the request. After the window ``check_requests`` of the kept
requests are compared with the reference, each on ``check_tasks`` of its
tasks drawn from the seed (:func:`checked_tasks`), over the whole grid,
by :func:`numbers`.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import inputs, work
from benchmark.entries import common
from benchmark.reference import convnp_spikes_beta as ref_sb
from benchmark.trace import Tracer, warm_profiler

MONTH_STREAM = 1         # the stream of ``inputs.rng_for`` of the pool's months, as serve_cycle's
CHECK_TASKS_STREAM = 7   # the stream that draws a checked request's tasks
KEEP_STREAM = 3          # the stream that decides which requests are kept
CHOOSE_STREAM = 6        # the stream that chooses the checked requests among the kept


def values(rng: np.random.Generator, shape: tuple, spec: dict) -> np.ndarray:
    """Humidity in model space [0, 1]: 0 with probability ``share_at_0``, 1
    (saturated) with probability ``share_at_1``, else Beta(``beta_a``,
    ``beta_b``)."""
    if spec["kind"] != "spikes-beta":
        raise ValueError(f"serve_month makes spikes-beta values, not {spec['kind']!r}")
    u = rng.random(shape)
    body = rng.beta(spec["beta_a"], spec["beta_b"], shape)
    out = np.where(u < spec["share_at_0"], 0.0,
                   np.where(u < spec["share_at_0"] + spec["share_at_1"], 1.0, body))
    return out.astype(np.float32)


def month(seed: int, k: int, dom, traffic: dict, spec: dict) -> dict:
    """Month ``k`` of the pool: ``tasks_per_request`` hourly tasks, each
    registry site absent with probability ``station_absent``, the stations
    padded to the month's largest count with masked slots (as
    ``inputs.serve_cycle`` lays them out), the base's day-of-year channels
    those of each task's day."""
    rng = inputs.rng_for(seed, MONTH_STREAM, k)
    B = traffic["tasks_per_request"]
    S = len(dom.sites)
    present = rng.random((B, S)) >= traffic["station_absent"]
    N = int(present.sum(1).max())
    st_x = np.full((B, N, 2), inputs.PAD_COORD, np.float32)
    st_y = np.zeros((B, N, 1), np.float32)
    st_m = np.zeros((B, N), np.float32)
    obs = values(rng, (B, S), spec)
    for b in range(B):
        idx = np.flatnonzero(present[b])
        st_x[b, :len(idx)] = dom.sites[idx]
        st_y[b, :len(idx), 0] = obs[b, idx]
        st_m[b, :len(idx)] = 1.0
    hb, wb = traffic["base_hw"]
    t = hours(traffic)
    day = 2.0 * np.pi * (t.astype("datetime64[D]") - t[0].astype("datetime64[Y]")).astype(
        np.float64) / 365.0
    base = np.empty((B, hb, wb, 3), np.float32)
    base[..., 0] = values(rng, (B, hb, wb), spec)
    base[..., 1] = np.cos(day)[:, None, None]
    base[..., 2] = np.sin(day)[:, None, None]
    return {"base": base, "aux": np.repeat(dom.aux[None], B, 0),
            "st_x": st_x, "st_y": st_y, "st_mask": st_m}


def hours(traffic: dict) -> np.ndarray:
    """The month's hourly times, datetime64[h]."""
    return np.datetime64(traffic["first_time"], "h") + np.arange(traffic["tasks_per_request"])


def spec_for(cell) -> dict:
    return ref_sb.param_spec(cell.config["model"],
                             [common.GRID_CHANNELS, cell.traffic["aux_channels"]],
                             [common.POINT_CHANNELS], common.AUX_AT_TARGETS)


def serve_inputs(cell, seed: int, device) -> tuple:
    """(domain, pool of months, weights) of the cell from the seed."""
    from benchmark.reference import convnp as ref

    dom = inputs.domain(cell.traffic, cell.config["model"], seed)
    pool = [month(seed, k, dom, cell.traffic, cell.config["values"])
            for k in range(cell.traffic["pool"])]
    return dom, pool, ref.weights_from(spec_for(cell), cell.config["model"], seed, device)


def checked_tasks(cell, seed: int, request: int) -> np.ndarray:
    """The tasks of ``request`` the check compares, drawn from the seed:
    ``check_tasks`` of them (or every task of a shorter request), one in
    the first chunk, one in the last and the rest anywhere."""
    tr = cell.traffic
    B = tr["tasks_per_request"]
    C = min(tr["predictor"]["batch_chunk"] or B, B)
    n = min(tr["check_tasks"], B)
    rng = inputs.rng_for(seed, CHECK_TASKS_STREAM, request)
    picks = {int(rng.integers(0, C))}
    last = [b for b in range((B - 1) // C * C, B) if b not in picks]
    if len(picks) < n and last:
        picks.add(int(rng.choice(last)))
    rest = np.setdiff1d(np.arange(B), sorted(picks))
    picks.update(int(b) for b in rng.choice(rest, n - len(picks), replace=False))
    return np.array(sorted(picks))


def reference_maps(cell, weights, dom, cycle: dict, tasks, device, prec=None) -> dict:
    cfg = cell.config
    return ref_sb.serve_maps(weights, cfg["model"], inputs.take(cycle, tasks), dom,
                             cfg["normalisation"], cell.traffic["predictor"]["std_scale"],
                             device, prec=prec)


def numbers(got: list, want: list, norm: dict) -> dict:
    """The numbers that decide ``correct``, per checked request (the worst
    counts): ``got`` the request's mean maps {"mean"}, ``want`` the
    reference's {"mean", "std"} of the same tasks, NaN on sea.

    - ``mean_err``: ‖Δmean‖₂ / ‖reference std‖₂ over the land, in model
      space: the mean's error against the forecast's own spread (the
      request downloads no std, so the scale is the reference's);
    - ``sea_mismatch``: cells finite in one mean map and not in the other,
      exact: limit 0.

    A number that is not finite fails its limit."""
    out = {"mean_err": 0.0, "sea_mismatch": 0.0}
    for g, r in zip(got, want):
        land = np.isfinite(r["mean"])
        out["sea_mismatch"] += float((np.isfinite(g["mean"]) != land).sum())
        gm = ref_sb.to_model_space({"mean": g["mean"]}, norm)["mean"]
        rm = ref_sb.to_model_space(r, norm)
        ok = land & np.isfinite(gm)
        scale = float(np.linalg.norm(rm["std"][ok]))
        err = float(np.linalg.norm(gm[ok] - rm["mean"][ok])) / scale if scale > 0 else np.inf
        out["mean_err"] = max(out["mean_err"], err)
    return out


def _work(cell, dom, pool, weights, n_traced: int) -> dict:
    """Model FLOPs and the SetConv kernels' bounds over the traced requests,
    counting what a request computes: per task the U-Net and the MLP head
    over the land cells; per chunk one B1 launch (the chunk's tasks' work,
    as ``serve`` counts it) and one B2 launch onto the land cells, its
    operations the whole grid's (``work.decode_grid_work``) scaled to the
    land's share and its bytes f read once and the cells' outputs written
    once (``chip_smoke.py``'s ``decode_grid on cells`` bound)."""
    m, tr = cell.config["model"], cell.traffic
    dens = m["internal_density"]
    H, W = len(dom.x1g), len(dom.x2g)
    Ht, Wt = dom.land.shape
    L = int(dom.land.sum())
    B = tr["tasks_per_request"]
    C = min(tr["predictor"]["batch_chunk"] or B, B)
    chunks = [np.minimum(np.arange(off, off + C), B - 1) for off in range(0, B, C)]
    cin = common.GRID_CHANNELS + 1 + tr["aux_channels"] + 1 + common.POINT_CHANNELS + 1
    per_task = (work.unet_flops(H, W, cin, m["unet_channels"], m["kernel_size"],
                                m["decoder_channels"])
                + work.mlp_flops(L, [m["decoder_channels"] + common.AUX_AT_TARGETS]
                                 + [m["mlp_hidden"]] * m["mlp_layers"]
                                 + [ref_sb.n_outputs(m)]))
    ls_p = common.lengthscale(weights, "ls_points_0", dens)
    ls_d = common.lengthscale(weights, "ls_decoder", dens)
    f_bytes = 2 if m["compute_dtype"] == "bfloat16" else 4
    whole, _ = work.decode_grid_work(dom.x1g, dom.x2g, dom.xt1, dom.xt2, ls_d, C,
                                     m["decoder_channels"], f_bytes)
    b2f = whole * L / (Ht * Wt)
    b2b = (C * H * W * m["decoder_channels"] * f_bytes + 4.0 * C * L * m["decoder_channels"]
           + 4 * (H + W + Ht + Wt))
    b1 = {}  # month → (FLOPs, bound seconds) of its chunks' B1 launches
    flops = b1_bound = 0.0
    for i in range(n_traced):
        k = i % len(pool)
        if k not in b1:
            cyc = pool[k]
            fb = [work.encode_work(dom.x1g, dom.x2g, x, mk, common.POINT_CHANNELS, ls_p)
                  for x, mk in zip(cyc["st_x"], cyc["st_mask"])]
            per_chunk = [(sum(fb[b][0] for b in idx), sum(fb[b][1] for b in idx) + 4.0 * (H + W))
                         for idx in chunks]
            b1[k] = (sum(f for f, _ in per_chunk),
                     sum(work.card_bound_s(f, by) for f, by in per_chunk))
        flops += len(chunks) * C * per_task + b1[k][0] + len(chunks) * b2f
        b1_bound += b1[k][1]
    n_launches = n_traced * len(chunks)
    return {"model_flops": flops, "b1": (b1_bound, n_launches),
            "b2": (n_launches * work.card_bound_s(b2f, b2b), n_launches)}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float) -> common.Outcome:
    import torch

    from deepsensornz_tpu_torch.data.grid import Field
    from deepsensornz_tpu_torch.data.processor import DataProcessor
    from deepsensornz_tpu_torch.infer.predict import Predictor
    from deepsensornz_tpu_torch.pipeline.validate import post_transform_for

    cfg, tr = cell.config, cell.traffic
    pr = tr["predictor"]
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
    predictor = Predictor(model, dp, cfg["variable"], std_scale=pr["std_scale"],
                          transfer_dtype=pr["transfer_dtype"], batch_chunk=pr["batch_chunk"],
                          download_threads=pr["download_threads"],
                          upload_dtype=pr["upload_dtype"])
    post = post_transform_for(pr["post_transform"])
    outputs = tuple(pr["outputs"])
    times = hours(tr)

    def request(i: int):
        return predictor.predict_grid(tasks[i % len(tasks)], dem, aux_at_targets=highres,
                                      times=times, n_samples=tr["n_samples"], seed=i,
                                      post_transform=post, outputs=outputs)

    for i in range(tr["warmup_requests"]):
        request(-1 - i)
    if trace:
        warm_profiler()
    torch.cuda.synchronize(device) if device.type == "cuda" else None
    setup_s = time.perf_counter() - t0

    keep = inputs.rng_for(seed, KEEP_STREAM).random(1 << 20) < tr["keep_share"]
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
            kept[i] = pred["mean"].data[checked_tasks(cell, seed, i)]
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
             "request_ms_min_median_max": [float(v) for v in q], "host_over_window": host}
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
    if not kept:  # a window too short to keep any: the last request's rows
        (j, pred), = last.items()
        kept[j] = pred["mean"].data[checked_tasks(cell, seed, j)]
    del predictor, model, tasks, last
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rng = inputs.rng_for(seed, CHOOSE_STREAM)
    chosen = sorted(rng.choice(sorted(kept), min(tr["check_requests"], len(kept)), replace=False))
    got, want, checked = [], [], {}
    for i in chosen:
        idx = checked_tasks(cell, seed, i)
        got.append({"mean": kept.pop(i)})
        want.append(reference_maps(cell, weights, dom, pool[i % len(pool)], idx, device))
        checked[int(i)] = [int(b) for b in idx]
    nums = numbers(got, want, cfg["normalisation"])
    notes["checked_requests"] = checked
    return common.Outcome(attempted=n, failed=0, e2e=e2e, numbers=nums, peak_bytes=peak,
                          readings=readings, notes=notes)
