"""The one general generator of the benchmark's inputs, from a seed and a
traffic file's parameters.

Everything is made on the host with numpy, as a loader would hand it to
the system: the NZ target grid and its land mask, the internal grid
(``internal_grid`` is a frozen copy of the port's ``ops/grids.py``
arithmetic), the static aux fields, the station sites (the 619 registry
sites of ``data/station_registry.json``, a frozen copy of the port's), and
per serving cycle or training task the base field, the stations present
and their values. The same arrays go to the port and to the reference.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np

REGISTRY = Path(__file__).resolve().parent / "data" / "station_registry.json"
KM_PER_DEGREE = 111.2
PAD_COORD = -1e3  # a masked slot's coordinate: its RBF weight underflows to 0


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent numpy stream per (seed, purpose, index)."""
    return np.random.default_rng([int(seed) % 2**64, *stream])


def internal_grid(x1_range, x2_range, density: float, margin: float = 0.1,
                  multiple: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """The ConvNP's internal grid: uniform with ``1/density`` spacing over
    the data extent plus a margin, each axis rounded up to ``multiple``
    points with the extra span split evenly; float32."""
    spacing = 1.0 / float(density)
    out = []
    for lo, hi in (x1_range, x2_range):
        lo, hi = float(lo) - margin, float(hi) + margin
        n = max(int(math.ceil((hi - lo) / spacing)) + 1, multiple)
        n = -(-n // multiple) * multiple
        start = lo - ((n - 1) * spacing - (hi - lo)) / 2.0
        out.append((start + spacing * np.arange(n)).astype(np.float32))
    return out[0], out[1]


def registry_sites() -> np.ndarray:
    """(S, 2) latitude, longitude of every registry site, in file order."""
    reg = json.loads(REGISTRY.read_text())
    return np.array([[v["latitude"], v["longitude"]] for v in reg.values()], np.float64)


def values(rng: np.random.Generator, shape: tuple, spec: dict) -> np.ndarray:
    """Normalised values of the configuration's variable: standard normal,
    or for precipitation dry (0) with probability ``dry_share`` and else
    Gamma(``gamma_shape``, ``gamma_scale``)."""
    if spec["kind"] == "normal":
        return rng.standard_normal(shape).astype(np.float32)
    if spec["kind"] == "dry-gamma":
        wet = rng.random(shape) >= spec["dry_share"]
        g = rng.gamma(spec["gamma_shape"], spec["gamma_scale"], shape)
        return np.where(wet, g, 0.0).astype(np.float32)
    raise ValueError(f"unknown value kind {spec['kind']!r}")


@dataclasses.dataclass
class Domain:
    """The static part of a cell: grids, land mask, sites and aux fields."""

    lat: np.ndarray          # (Ht,) target latitudes
    lon: np.ndarray          # (Wt,) target longitudes
    xt1: np.ndarray          # (Ht,) float32 x-space
    xt2: np.ndarray          # (Wt,)
    land: np.ndarray         # (Ht, Wt) bool
    base_x: tuple            # x-space coordinates of the base grid
    aux_x: tuple
    highres_x: tuple
    aux: np.ndarray          # (Ha, Wa, A) static aux channels
    highres: np.ndarray      # (Hh, Wh) aux sampled at the targets
    sites: np.ndarray        # (S, 2) float32 x-space station sites
    x1g: np.ndarray
    x2g: np.ndarray

    def site_highres(self, idx: np.ndarray) -> np.ndarray:
        """The highres aux at sites ``idx`` (nearest cell), (n, 1)."""
        h1, h2 = self.highres_x
        i = np.abs(h1[None, :] - self.sites[idx, 0:1]).argmin(1)
        j = np.abs(h2[None, :] - self.sites[idx, 1:2]).argmin(1)
        return self.highres[i, j][:, None].astype(np.float32)


def land_mask(lat: np.ndarray, lon: np.ndarray, sites: np.ndarray, share: float) -> np.ndarray:
    """Cells within a radius of some registry site, the radius chosen so
    that ``share`` of the cells are land."""
    la, lo = np.meshgrid(lat, lon, indexing="ij")
    cells = np.stack([la.ravel(), lo.ravel()], -1)
    dmin = np.empty(len(cells))
    for s in range(0, len(cells), 4096):
        c = cells[s:s + 4096]
        dy = (c[:, None, 0] - sites[None, :, 0]) * KM_PER_DEGREE
        dx = ((c[:, None, 1] - sites[None, :, 1]) * KM_PER_DEGREE
              * np.cos(np.radians(c[:, None, 0])))
        dmin[s:s + 4096] = np.sqrt(dy * dy + dx * dx).min(1)
    radius = np.quantile(dmin, share)
    return (dmin <= radius).reshape(len(lat), len(lon))


def domain(traffic: dict, model: dict, seed: int) -> Domain:
    e = traffic["extent"]
    Ht, Wt = traffic["target_hw"]
    lat = np.linspace(e["minlat"], e["maxlat"], Ht)
    lon = np.linspace(e["minlon"], e["maxlon"], Wt)
    latlon = registry_sites()
    inside = ((latlon[:, 0] >= e["minlat"]) & (latlon[:, 0] <= e["maxlat"])
              & (latlon[:, 1] >= e["minlon"]) & (latlon[:, 1] <= e["maxlon"]))
    latlon = latlon[inside]
    sites = np.stack([(latlon[:, 0] - e["minlat"]) / (e["maxlat"] - e["minlat"]),
                      (latlon[:, 1] - e["minlon"]) / (e["maxlon"] - e["minlon"])],
                     -1).astype(np.float32)

    def unit(hw):
        return tuple(np.linspace(0.0, 1.0, n).astype(np.float32) for n in hw)

    rng = rng_for(seed, 0)
    x1g, x2g = internal_grid((0.0, 1.0), (0.0, 1.0), model["internal_density"])
    return Domain(
        lat=lat, lon=lon,
        xt1=((lat - e["minlat"]) / (e["maxlat"] - e["minlat"])).astype(np.float32),
        xt2=((lon - e["minlon"]) / (e["maxlon"] - e["minlon"])).astype(np.float32),
        land=land_mask(lat, lon, latlon, traffic["land_share"]),
        base_x=unit(traffic["base_hw"]), aux_x=unit(traffic["aux_hw"]),
        highres_x=unit(traffic["highres_hw"]),
        aux=rng.standard_normal(tuple(traffic["aux_hw"]) + (traffic["aux_channels"],)
                                ).astype(np.float32),
        highres=rng.standard_normal(tuple(traffic["highres_hw"])).astype(np.float32),
        sites=sites, x1g=x1g, x2g=x2g)


def _base(rng, dom: Domain, traffic: dict, spec: dict, n: int) -> np.ndarray:
    """(n, Hb, Wb, 3): the variable, then cos and sin of the day of year."""
    hb, wb = traffic["base_hw"]
    day = 2.0 * np.pi * rng.integers(0, 365) / 365.0
    out = np.empty((n, hb, wb, 3), np.float32)
    out[..., 0] = values(rng, (n, hb, wb), spec)
    out[..., 1] = np.cos(day)
    out[..., 2] = np.sin(day)
    return out


def serve_cycle(seed: int, k: int, dom: Domain, traffic: dict, spec: dict) -> dict:
    """Serving cycle ``k`` of the pool: ``tasks_per_request`` hourly tasks,
    each registry site absent with probability ``station_absent``, the
    stations padded to the cycle's largest count with masked slots."""
    rng = rng_for(seed, 1, k)
    B = traffic["tasks_per_request"]
    S = len(dom.sites)
    present = rng.random((B, S)) >= traffic["station_absent"]
    N = int(present.sum(1).max())
    st_x = np.full((B, N, 2), PAD_COORD, np.float32)
    st_y = np.zeros((B, N, 1), np.float32)
    st_m = np.zeros((B, N), np.float32)
    obs = values(rng, (B, S), spec)
    for b in range(B):
        idx = np.flatnonzero(present[b])
        st_x[b, :len(idx)] = dom.sites[idx]
        st_y[b, :len(idx), 0] = obs[b, idx]
        st_m[b, :len(idx)] = 1.0
    return {"base": _base(rng, dom, traffic, spec, B),
            "aux": np.repeat(dom.aux[None], B, 0),
            "st_x": st_x, "st_y": st_y, "st_mask": st_m}


def train_pool(seed: int, dom: Domain, traffic: dict, spec: dict) -> dict:
    """``pool_tasks`` training tasks: context and target stations drawn
    from the registry sites (each set without repeats), their values and
    the highres aux at the targets."""
    rng = rng_for(seed, 2)
    T, nc, nt = traffic["pool_tasks"], traffic["context_stations"], traffic["target_stations"]
    S = len(dom.sites)
    ctx = np.stack([rng.choice(S, nc, replace=False) for _ in range(T)])
    tgt = np.stack([rng.choice(S, nt, replace=False) for _ in range(T)])
    base = np.concatenate([_base(rng, dom, traffic, spec, 1) for _ in range(T)])
    return {"base": base, "aux": np.repeat(dom.aux[None], T, 0),
            "st_x": dom.sites[ctx], "st_y": values(rng, (T, nc, 1), spec),
            "st_mask": np.ones((T, nc), np.float32),
            "xt": dom.sites[tgt], "yt": values(rng, (T, nt, 1), spec),
            "yt_mask": np.ones((T, nt), np.float32),
            "yt_aux": np.stack([dom.site_highres(t) for t in tgt])}


def take(arrays: dict, idx) -> dict:
    """The tasks ``idx`` of a dict of task arrays."""
    return {k: v[idx] for k, v in arrays.items()}
