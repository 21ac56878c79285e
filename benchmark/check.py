"""The numbers that decide ``correct``, and their limits.

Serving: what a request returned against the plain reference's maps of
the same inputs, over the land cells of every task of the sampled
requests (the worst request counts):

- ``moments_err``: √(‖Δmean‖₂² + ‖Δstd‖₂²) / ‖ref std‖₂, the error of
  both maps against the forecast's own spread (the normalised mean of
  random weights can lie near 0, so its own norm is no steady scale; the
  std map alone moves too little under the control to separate it);
- ``sea_mismatch``: cells finite in one and not the other (sea is NaN,
  land finite), exact: limit 0;
- with samples, ``wet_flip``: the share of sampled land cells wet (> 0)
  in one and dry in the other, and ``sample_off``: the share of the cells
  wet in both whose values differ by more than 1 % of the reference plus
  1e-4 of the map's largest value (the int16 steps of two maps scaled
  apart). A share and not a norm: the Gamma sampler's rejection step
  turns a rounding-sized change of a cell's shape into a wholly other
  draw in a few cells, which would swing a norm from seed to seed.

Training: each of the first steps' loss, the first gradient as the
optimizer gets it and the parameters' change over the steps, each leaf
by its norm; a leaf's gap between the program's norm and the reference's
is measured against the larger of the reference's norm of that leaf and
of the median leaf:

- ``loss_gap``: the largest |got − ref| / |ref| over the steps;
- ``grad_gap``: the largest gap of the first gradient's leaf norms;
- ``update_gap``: the largest gap of the change's leaf norms, over the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (the others move under Adam by round-off alone).

A number that is not finite fails its limit.
"""

from __future__ import annotations

import math

import numpy as np


def _rel(got: np.ndarray, ref: np.ndarray, scale: np.ndarray) -> float:
    d = np.linalg.norm((got.astype(np.float64) - ref.astype(np.float64)).ravel())
    n = np.linalg.norm(scale.astype(np.float64).ravel())
    return float(d / n) if n > 0 else float("inf")


def serve_numbers(got: list, ref: list) -> dict:
    """``got``, ``ref``: per sampled request, maps {"mean", "std"[,
    "samples"]} of the same shape, NaN on sea."""
    out = {"moments_err": 0.0, "sea_mismatch": 0.0}
    for g, r in zip(got, ref):
        land = np.isfinite(r["mean"])
        ok = land & np.isfinite(g["mean"]) & np.isfinite(g["std"])
        for key in ("mean", "std"):
            out["sea_mismatch"] += float((np.isfinite(g[key]) != land).sum())
        both = np.concatenate([g["mean"][ok], g["std"][ok]])
        want = np.concatenate([r["mean"][ok], r["std"][ok]])
        out["moments_err"] = max(out["moments_err"], _rel(both, want, r["std"][ok]))
        if "samples" in r:
            gs, rs = g["samples"], r["samples"]
            cells = np.broadcast_to(land, rs.shape) & np.isfinite(gs)
            out["sea_mismatch"] += float((np.isfinite(gs) != np.broadcast_to(land, rs.shape)).sum())
            gw, rw = gs[cells] > 0, rs[cells] > 0
            out["wet_flip"] = max(out.get("wet_flip", 0.0), float((gw != rw).mean()))
            both = gw & rw
            g1, r1 = gs[cells][both].astype(np.float64), rs[cells][both].astype(np.float64)
            tol = 0.01 * np.abs(r1) + 1e-4 * np.abs(rs[cells]).max()
            out["sample_off"] = max(out.get("sample_off", 0.0), float((np.abs(g1 - r1) > tol).mean()))
    return out


def leaf_gaps(got: dict, ref: dict, keep) -> dict:
    """Per leaf in ``keep``: |got − ref| / max(ref, the median leaf's ref)."""
    med = float(np.median([ref[k] for k in keep]))
    return {k: abs(got[k] - ref[k]) / max(ref[k], med) for k in keep}


def _worst(gaps: dict) -> float:
    v = list(gaps.values())
    return max(v) if all(map(math.isfinite, v)) else float("inf")


def moved_leaves(ref_grad: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = float(np.median(list(ref_grad.values())))
    return [k for k in ref_grad if ref_grad[k] >= 1e-3 * med]


def train_diagnostics(got: dict, ref: dict) -> dict:
    """Each step's loss gap, and the three worst leaves of each comparison
    and the median leaf's gap."""
    out = {"loss_gaps": [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])],
           "unmoved_leaves": sorted(set(ref["grad"]) - set(moved_leaves(ref["grad"])))}
    for key, keep in (("grad", list(ref["grad"])), ("update", moved_leaves(ref["grad"]))):
        g = leaf_gaps(got[key], ref[key], keep)
        out[f"{key}_worst"] = sorted(g.items(), key=lambda kv: -kv[1])[:3]
        out[f"{key}_median_gap"] = float(np.median(list(g.values())))
    return out


def train_numbers(got: dict, ref: dict) -> dict:
    """``got``, ``ref``: {"losses": [...], "grad": {leaf: norm},
    "update": {leaf: norm}}; the reference's ``grad`` decides the leaves."""
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    if len(losses) != len(ref["losses"]) or not all(map(math.isfinite, losses)):
        losses = [float("inf")]
    return {"loss_gap": max(losses),
            "grad_gap": _worst(leaf_gaps(got["grad"], ref["grad"], list(ref["grad"]))),
            "update_gap": _worst(leaf_gaps(got["update"], ref["update"],
                                           moved_leaves(ref["grad"])))}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    table = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    missing = set(limits) - set(numbers)
    return ok and not missing, table
