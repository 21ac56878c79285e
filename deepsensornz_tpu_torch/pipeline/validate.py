"""Reconstruct a trained run from its directory, and validate it.

Counterpart of ``deepsensornz_tpu/pipeline/validate.py``:

- :func:`load_run` reads a run directory into the port's model and loader;
- :class:`Validate` scores the run at held-out stations: RMSE/MAE/bias per
  channel, elevation bands, the base field's baselines, calibration
  z-scores, the randomised PIT, CRPS, spatial-extrapolation holdouts and
  wet/dry skill;
- :class:`ValidateERA` predicts on the DEM grid from raw base fields and
  stations, normalised with the run's processor and swapped into its
  loader; :class:`ValidateWRF` does so for a forecast cycle read by a
  caller's source object.

Station tables are ``StationFrame`` objects; a pandas DataFrame passed to
a public method is converted once (``StationFrame.from_pandas``). Nothing
here needs pandas.

A run directory, as the JAX
package's ``Train.train_model`` or the port writes it, holds
``task_loader.pkl``, ``data_processor.json``, ``metadata.json`` and the
parameters (``params.pt``, or the JAX package's ``params.msgpack``).

The JAX package pickles its own ``TaskLoader`` (station sets as pandas
DataFrames, grids as its ``Field``/``Dataset``); :func:`load_task_loader`
reads such a pickle, or the port's own, into the port's classes.
DataFrames need pandas to unpickle: without pandas that pickle raises an
error that says so. :func:`save_task_loader` writes the JAX layout where
pandas is installed, so the JAX package serves a run the port trained,
and the port's own pickle (no pandas object in it) elsewhere.
"""

from __future__ import annotations

import copyreg
import json
import os
import pickle
from typing import Optional, Sequence

import numpy as np
import torch

from deepsensornz_tpu_torch import config as cfg
from deepsensornz_tpu_torch.data.features import (circ_time_encoding,
                                                  shift_humidity_from_unit_interval)
from deepsensornz_tpu_torch.data.frame import FrameUnpickler, StationFrame, is_pandas_frame
from deepsensornz_tpu_torch.data.grid import Dataset, Field
from deepsensornz_tpu_torch.data.processor import DataProcessor
from deepsensornz_tpu_torch.infer.predict import Predictor
from deepsensornz_tpu_torch.models.convnp import ConvNP, ConvNPConfig
from deepsensornz_tpu_torch.task.loader import TaskLoader
from deepsensornz_tpu_torch.train.checkpoint import load_checkpoint

# the JAX package's pickled classes and the port's counterparts
_JAX_CLASSES = {
    ("deepsensornz_tpu.task.loader", "TaskLoader"): TaskLoader,
    ("deepsensornz_tpu.data.grid", "Field"): Field,
    ("deepsensornz_tpu.data.grid", "Dataset"): Dataset,
}
_JAX_NAMES = {cls: name for name, cls in _JAX_CLASSES.items()}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises rather
    than falling back to the CPU (pass ``device="cpu"`` for that)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


class _RunUnpickler(FrameUnpickler):
    def find_class(self, module: str, name: str):
        cls = _JAX_CLASSES.get((module, name))
        return cls if cls is not None else super().find_class(module, name)


def load_task_loader(path: str) -> TaskLoader:
    """A pickled ``TaskLoader`` of the port or of the JAX package."""
    with open(path, "rb") as f:
        tl = _RunUnpickler(
            f, "this task_loader.pkl holds pandas DataFrames (a loader pickled by the JAX "
               "package) and pandas is not installed; load it once where pandas is installed "
               "and pickle the port's TaskLoader again").load()
    if not isinstance(tl, TaskLoader):
        raise TypeError(f"{path} holds a {type(tl).__name__}, not a TaskLoader")
    return tl


class _JaxLayoutPickler(pickle._Pickler):
    """Pickles the port's loader as the JAX package's: its three classes
    are written by name as the JAX classes (the standard pickler would
    import the JAX package to check each name, and that pulls in jax), and
    the loader's state is the JAX ``__dict__``, whose class has no
    ``__setstate__``: station sets as DataFrames, ``_flat_cache`` empty."""

    def __init__(self, file, frames: dict):
        super().__init__(file, protocol=pickle.DEFAULT_PROTOCOL)
        self.frames = frames

    def save_global(self, obj, name=None):
        where = _JAX_NAMES.get(obj)
        if where is None:
            return super().save_global(obj, name)
        self.write(pickle.GLOBAL + f"{where[0]}\n{where[1]}\n".encode("utf-8"))
        self.memoize(obj)

    def reducer_override(self, obj):
        if isinstance(obj, TaskLoader):
            state = dict(obj.__getstate__())
            state["context"] = [self.frames.get(id(c), c) for c in state["context"]]
            state["target"] = self.frames.get(id(state["target"]), state["target"])
            state["_flat_cache"] = {}
            return copyreg.__newobj__, (TaskLoader,), state
        return NotImplemented


def save_task_loader(tl: TaskLoader, path: str) -> None:
    """Pickle a loader for a run directory. Where pandas is installed the
    file holds the JAX package's ``TaskLoader`` (its class paths, station
    sets as the DataFrames its preprocessing makes), which both packages
    read; elsewhere it holds the port's loader, as ``pickle.dump`` writes
    it, and a line says so: load it where pandas is installed and save it
    again to serve it in the JAX package."""
    try:
        import pandas  # noqa: F401
    except ImportError:
        with open(path, "wb") as f:
            pickle.dump(tl, f)
        print(f"{path}: the port's TaskLoader layout (pandas is not installed); the JAX "
              "package reads it after load_task_loader + save_task_loader where pandas is")
        return
    frames = {}
    for e in list(tl.context) + [tl.target]:
        if isinstance(e, StationFrame) and id(e) not in frames:
            frames[id(e)] = e.to_pandas()
    with open(path, "wb") as f:
        _JaxLayoutPickler(f, frames).dump(tl)


def load_run(model_dir: str, device=None) -> dict:
    """{model, params (its ``state_dict``), task_loader, data_processor,
    metadata, variable, std_scale} of a training-run directory; the model
    on ``device`` (``None``: the card) in eval mode."""
    dev = resolve_device(device)
    task_loader = load_task_loader(os.path.join(model_dir, "task_loader.pkl"))
    dp = DataProcessor.load(os.path.join(model_dir, "data_processor.json"))
    with open(os.path.join(model_dir, "metadata.json")) as f:
        metadata = json.load(f)
    kw = metadata.get("convnp_kwargs", {})
    var = metadata.get("data_settings", {}).get("variable", "temperature")
    mc = metadata.get("model_config")
    if mc:
        model_cfg = ConvNPConfig.from_dict(mc)
    else:
        default = cfg.CONVNP_KWARGS_DEFAULT
        model_cfg = ConvNPConfig(
            unet_channels=tuple(kw.get("unet_channels", default["unet_channels"])),
            likelihood=kw.get("likelihood", cfg.LIKELIHOODS.get(var, "cnp")),
            internal_density=kw.get("internal_density", default["internal_density"]),
            dim_yt=task_loader.target_dim(),
            sigmoid_output=(var == "humidity" and kw.get("likelihood") in ("cnp", "gnp")),
        )
    # sized from one materialised task; the seeded draw is overwritten below
    example = task_loader([_first_time(task_loader)], seed_override=0)
    model = ConvNP.from_task(model_cfg, example, generator=torch.Generator().manual_seed(0))
    params = load_checkpoint(model_dir, upsample=model_cfg.upsample)["params"]
    model.load_state_dict(params, strict=True)
    model = model.to(dev).eval()
    return {
        "model": model,
        "params": model.state_dict(),
        "task_loader": task_loader,
        "data_processor": dp,
        "metadata": metadata,
        "variable": var,
        # the spread recalibration fit at train time; 1.0 when absent
        "std_scale": float(metadata.get("std_scale", 1.0)),
    }


def _first_time(task_loader: TaskLoader):
    for entry in list(task_loader.context) + [task_loader.target]:
        if isinstance(entry, StationFrame):
            return entry["time"][0]
        for f in (entry.values() if isinstance(entry, Dataset) else [entry]):
            if "time" in f.dims:
                return f.coords["time"][0]
    raise ValueError("no time coordinate found in task loader data")


def _as_frame(df):
    """A pandas DataFrame as a ``StationFrame``; anything else unchanged."""
    return StationFrame.from_pandas(df) if is_pandas_frame(df) else df


def humidity_post_transform(mean, std):
    """[0,1] model space → [-1,1] min_max space before unnormalisation
    (the inverse of preprocessing's shift); ``std=None`` passes through."""
    mean = shift_humidity_from_unit_interval(mean)
    std = None if std is None else np.asarray(std) * 2.0
    return mean, std


def post_transform_for(variable: str):
    return humidity_post_transform if variable == "humidity" else None


def _nearest_index(coord: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Index of the nearest ``coord`` entry for each query (any coord order)."""
    coord = np.asarray(coord, np.float64)
    query = np.asarray(query, np.float64)
    if len(coord) == 1:
        return np.zeros(len(query), np.intp)
    order = np.argsort(coord)
    cs = coord[order]
    pos = np.clip(np.searchsorted(cs, query), 1, len(cs) - 1)
    pick = np.where(np.abs(query - cs[pos - 1]) <= np.abs(cs[pos] - query), pos - 1, pos)
    return order[pick]


def _station_key(frame: StationFrame) -> Optional[str]:
    for key in ("station_name", "station_id"):
        if key in frame.columns:
            return key
    return None


def remove_stations_from_frame(df, station_names: Sequence[str]):
    """The rows of a station table whose ``station_name`` (else
    ``station_id``), compared as strings, is not among ``station_names``;
    the table itself when no names are given or it has neither column."""
    df = _as_frame(df)
    key = _station_key(df)
    if not station_names or key is None:
        return df
    wanted = np.asarray(sorted({str(s) for s in station_names}))
    return df[~np.isin(df[key].astype(str), wanted)]


def registry_elevation_lookup(max_dist_deg: float = 0.02):
    """``lookup(lat, lon)``: the elevation of the nearest station of the
    shipped registry within ``max_dist_deg`` (~2 km), else None."""
    entries = [(v["latitude"], v["longitude"], v["elevation"])
               for v in cfg.station_registry().values() if v["elevation"] is not None]
    lats = np.asarray([e[0] for e in entries])
    lons = np.asarray([e[1] for e in entries])
    elevs = np.asarray([e[2] for e in entries])

    def lookup(lat: float, lon: float):
        d2 = np.square(lats - lat) + np.square(lons - lon)
        i = int(np.argmin(d2))
        return float(elevs[i]) if d2[i] <= max_dist_deg ** 2 else None

    return lookup


def _rows_at_dates(station_df: StationFrame, dates) -> StationFrame:
    """The rows at ``dates``, compared as nanoseconds (a [D] and an [ns]
    stamp of one instant differ as datetime64 values)."""
    def ns(t):
        return np.asarray(t).astype("datetime64[ns]").astype(np.int64)

    return station_df[np.isin(ns(station_df["time"]), ns(list(dates)))]


def _z_summary(z: np.ndarray) -> dict:
    zf = z[np.isfinite(z)]
    return {
        "z_mean": float(zf.mean()) if len(zf) else np.nan,
        "z_std": float(zf.std()) if len(zf) else np.nan,
        "coverage_95": float(np.mean(np.abs(zf) < 1.96)) if len(zf) else np.nan,
        "coverage_68": float(np.mean(np.abs(zf) < 1.0)) if len(zf) else np.nan,
        "n": int(len(zf)),
    }


def _error_summary(e: np.ndarray) -> dict:
    any_f = np.isfinite(e).any()
    return {
        "rmse": float(np.sqrt(np.nanmean(e ** 2))) if any_f else np.nan,
        "mae": float(np.nanmean(np.abs(e))) if any_f else np.nan,
        "bias": float(np.nanmean(e)) if any_f else np.nan,
        "n": int(np.isfinite(e).sum()),
    }


class Validate:
    """Research validation of a run against held-out stations: the
    stations named in ``remove_stations`` leave the context and stay
    targets. ``Validate(model_dir, device=...)`` loads the run on
    ``device`` (``None``: the card); ``Validate(run=...)`` takes a run dict
    as :func:`load_run` returns it."""

    def __init__(self, model_dir: Optional[str] = None, run: Optional[dict] = None,
                 device=None):
        self.run = run or load_run(model_dir, device=device)
        self.predictor = Predictor(
            self.run["model"], self.run["data_processor"],
            # one name per target channel (dim_yt > 1 scores each channel
            # with its own stats)
            self.run["task_loader"].target_var_IDs,
            std_scale=self.run.get("std_scale", 1.0))

    @property
    def task_loader(self) -> TaskLoader:
        return self.run["task_loader"]

    def _unnormalise_obs(self, yt: np.ndarray) -> np.ndarray:
        """Normalised targets (..., M, dy) in physical units, each channel
        through its own variable's affine."""
        yt = np.asarray(yt, np.float64)
        if self.run["variable"] == "humidity":
            yt = yt * 2.0 - 1.0  # undo the unit-interval shift first
        scale, offset = self.predictor._affines()  # (dy,), (dy,)
        return yt * scale + offset

    @staticmethod
    def _as_channels(arr: np.ndarray, dy: int) -> np.ndarray:
        """(B, M) single-channel arrays → (B, M, 1); (B, M, dy) unchanged."""
        arr = np.asarray(arr, np.float64)
        return arr[..., None] if arr.ndim == 2 and dy >= 1 else arr

    def _make_tasks(self, dates, remove_stations: Sequence[str] = (), seed_override: int = 42):
        """Tasks for ``dates`` with the listed stations removed from every
        station CONTEXT set (the targets keep them). The loader's fast-path
        cache is keyed by each frame's identity, so the filtered frames are
        never served its entries for the originals."""
        tl = self.task_loader
        saved_context = list(tl.context)
        try:
            if remove_stations:
                tl.context = [remove_stations_from_frame(c, remove_stations)
                              if isinstance(c, StationFrame) else c for c in tl.context]
            return tl(list(dates), seed_override=seed_override)
        finally:
            tl.context = saved_context

    def get_predictions(self, dates, remove_stations: Sequence[str] = (),
                        seed_override: int = 42) -> dict:
        """Mean/std at the station targets of ``dates`` (``predict_points``)
        with the task's ``xt`` and ``yt``."""
        task = self._make_tasks(dates, remove_stations, seed_override)
        out = self.predictor.predict_points(
            task, post_transform=post_transform_for(self.run["variable"]))
        out["xt"] = task.xt.numpy()
        out["yt"] = task.yt.numpy()
        return out

    def calculate_loss(self, dates, remove_stations: Sequence[str] = ()) -> dict:
        """RMSE/MAE/bias of the predicted mean against the observations in
        physical units, pooled and ``per_channel`` (keyed by
        ``target_var_IDs``); the per-slot ``errors``, ``pred_mean`` and
        ``obs`` are (B, M) for one channel, (B, M, dy) otherwise."""
        pred = self.get_predictions(dates, remove_stations)
        obs = self._unnormalise_obs(pred["yt"])  # (B, M, dy)
        dy = obs.shape[-1]
        mask = pred["mask"]
        mean = self._as_channels(pred["mean"], dy)
        err = np.where(mask[..., None], mean - obs, np.nan)
        obs_m = np.where(mask[..., None], obs, np.nan)
        per_channel = {
            vid: {"rmse": float(np.sqrt(np.nanmean(err[..., c] ** 2))),
                  "mae": float(np.nanmean(np.abs(err[..., c]))),
                  "bias": float(np.nanmean(err[..., c]))}
            for c, vid in enumerate(self.task_loader.target_var_IDs)
        }
        squeeze = dy == 1
        return {
            "rmse": float(np.sqrt(np.nanmean(err ** 2))),
            "mae": float(np.nanmean(np.abs(err))),
            "bias": float(np.nanmean(err)),
            "per_channel": per_channel,
            "errors": err[..., 0] if squeeze else err,
            "pred_mean": mean[..., 0] if squeeze else mean,
            "obs": obs_m[..., 0] if squeeze else obs_m,
            "xt": pred["xt"],
        }

    def elevation_band_errors(
        self,
        dates,
        remove_stations: Sequence[str] = (),
        bands: Sequence[tuple] = (
            ("Low (<500m)", None, 500.0),
            ("Mid (500m - 1000m)", 500.0, 1000.0),
            ("High (>1000m)", 1000.0, None),
        ),
        elevation_lookup=None,
        errors: Optional[np.ndarray] = None,
        xt: Optional[np.ndarray] = None,
    ) -> dict:
        """Per-station RMSE grouped by elevation band (lower bound
        inclusive, upper exclusive, ``None`` open). Target slots are grouped
        into stations by their (lat, lon) rounded to 4 decimals;
        ``elevation_lookup(lat, lon) -> float | None`` resolves a station's
        elevation (default: :func:`registry_elevation_lookup`; a station it
        does not resolve is left out). ``errors``/``xt`` band a precomputed
        error set instead of predicting. Returns ``{"bands": {label:
        [per-station rmse]}, "stations": {(lat, lon): {"rmse",
        "elevation", "band"}}}``."""
        if errors is None or xt is None:
            loss = self.calculate_loss(dates, remove_stations)
            errors, xt = loss["errors"], loss["xt"]
        if elevation_lookup is None:
            elevation_lookup = registry_elevation_lookup()
        dp = self.run["data_processor"]
        lat = np.asarray(dp.unmap_x1(xt[..., 0]))
        lon = np.asarray(dp.unmap_x2(xt[..., 1]))
        per_station: dict[tuple, list] = {}
        errors = np.asarray(errors)
        keys = np.stack([lat.ravel().round(4), lon.ravel().round(4)], -1)
        if errors.ndim == 3:  # dim_yt > 1: every channel shares its slot's key
            keys = np.repeat(keys, errors.shape[-1], axis=0)
        for k, e in zip(map(tuple, keys), errors.ravel()):
            if np.isfinite(e):
                per_station.setdefault(k, []).append(e)
        band_errs = {label: [] for label, _, _ in bands}
        stations = {}
        for (la, lo), errs in per_station.items():
            elev = elevation_lookup(la, lo)
            if elev is None:
                continue
            st_rmse = float(np.sqrt(np.mean(np.square(errs))))
            for label, lo_e, hi_e in bands:
                if (lo_e is None or elev >= lo_e) and (hi_e is None or elev < hi_e):
                    band_errs[label].append(st_rmse)
                    stations[(la, lo)] = {"rmse": st_rmse, "elevation": float(elev),
                                          "band": label}
                    break
        return {"bands": band_errs, "stations": stations}

    @staticmethod
    def _base_pairs_at_stations(base_field: Field, station_df):
        """``(keys, base, obs)`` for every station row where both are
        finite: keys (N, 2) of (lat, lon) rounded to 5 decimals, the base
        field at the nearest time and cell, the observation from the first
        column whose name ends in ``_station``."""
        station_df = _as_frame(station_df)
        col = [c for c in station_df.columns if c.endswith("_station")][0]
        lat_c = np.asarray(base_field.coords[base_field.dims[-2]], np.float64)
        lon_c = np.asarray(base_field.coords[base_field.dims[-1]], np.float64)
        t_c = np.asarray(base_field.coords["time"]).astype("datetime64[s]")
        st_t = station_df["time"].astype("datetime64[s]")
        st_lat = station_df["latitude"].astype(np.float64)
        st_lon = station_df["longitude"].astype(np.float64)
        obs = station_df[col].astype(np.float64)
        ti = _nearest_index(t_c.astype(np.int64), st_t.astype(np.int64))
        li = _nearest_index(lat_c, st_lat)
        lo = _nearest_index(lon_c, st_lon)
        base = np.asarray(base_field.data)[ti, li, lo].astype(np.float64)
        ok = np.isfinite(base) & np.isfinite(obs)
        keys = np.stack([st_lat.round(5), st_lon.round(5)], -1)
        return keys[ok], base[ok], obs[ok]

    @classmethod
    def _base_errors_at_stations(cls, base_field: Field, station_df):
        """((lat, lon), base − obs) for every finite station row."""
        keys, base, obs = cls._base_pairs_at_stations(base_field, station_df)
        for k, b, o in zip(keys, base, obs):
            yield (float(k[0]), float(k[1])), float(b - o)

    def calculate_loss_base(self, base_field: Field, station_df) -> dict:
        """The baseline: the raw base field at the stations (nearest time
        and cell) against their observations. Its ``mae`` is also the base
        copy's CRPS (a deterministic forecast's CRPS is |error|), the
        proper-score comparison for :meth:`crps`."""
        _, base, obs = self._base_pairs_at_stations(base_field, station_df)
        errs = base - obs
        return {
            "rmse": float(np.sqrt(np.mean(errs ** 2))) if len(errs) else np.nan,
            "mae": float(np.mean(np.abs(errs))) if len(errs) else np.nan,
            "bias": float(np.mean(errs)) if len(errs) else np.nan,
            "n": len(errs),
        }

    def per_station_loss_base(self, base_field: Field, station_df, dates=None) -> dict:
        """Per-station mean and std of a base field's |error| at the
        stations (rows at ``dates`` only, when given), and the mean of those
        means and of those stds across stations."""
        station_df = _as_frame(station_df)
        if dates is not None:
            station_df = _rows_at_dates(station_df, dates)
        keys, base, obs = self._base_pairs_at_stations(base_field, station_df)
        per: dict[tuple, list] = {}
        for k, e in zip(keys, np.abs(base - obs)):
            per.setdefault((float(k[0]), float(k[1])), []).append(e)
        stats = {k: (float(np.mean(e)), float(np.std(e))) for k, e in per.items()}
        means = [m for m, _ in stats.values()]
        stds = [s for _, s in stats.values()]
        return {
            "per_station": stats,
            "mean_of_means": float(np.mean(means)) if means else np.nan,
            "mean_of_stds": float(np.mean(stds)) if stds else np.nan,
            "n_stations": len(stats),
        }

    def calibration_stats(self, dates, remove_stations: Sequence[str] = ()) -> dict:
        """z = (obs − mean)/std at the targets: its mean and std, the shares
        inside |z| < 1.96 and < 1, and n (per channel too for dim_yt > 1).
        Calibrated Gaussian predictions give z_mean ≈ 0, z_std ≈ 1,
        coverage_95 ≈ 0.95."""
        pred = self.get_predictions(dates, remove_stations)
        obs = self._unnormalise_obs(pred["yt"])  # (B, M, dy)
        dy = obs.shape[-1]
        mask = pred["mask"]
        mean = self._as_channels(pred["mean"], dy)
        std = self._as_channels(pred["std"], dy)
        z = np.where(mask[..., None], (obs - mean) / np.maximum(std, 1e-9), np.nan)
        out = _z_summary(z)
        if dy > 1:
            out["per_channel"] = {vid: _z_summary(z[..., c])
                                  for c, vid in enumerate(self.task_loader.target_var_IDs)}
        return out

    def _shipped_raw(self, dates, remove_stations):
        """(task on the model's device, the head's raw output with the run's
        ``std_scale`` applied): one forward under inference mode."""
        task = self._make_tasks(dates, remove_stations).to(self.predictor.device)
        lik = self.predictor.likelihood
        with torch.inference_mode():
            raw = lik.rescale_raw(self.run["model"](task), self.predictor.std_scale)
        return task, raw

    def pit_stats(self, dates, remove_stations: Sequence[str] = (), seed: int = 0,
                  return_samples: bool = False) -> dict:
        """Randomised PIT, for every head: u ~ U(F(y⁻), F(y)) is uniform iff
        the predictive distribution is calibrated; reported as
        z = Φ⁻¹(u) on :meth:`calibration_stats`' scale (so
        :meth:`calibration_gate` applies to the mixed heads too), with the
        run's ``std_scale``. ``u`` draws from ``np.random.default_rng(seed)``;
        ``return_samples`` adds the finite z values as ``z``."""
        from scipy.special import ndtri

        task, raw = self._shipped_raw(dates, remove_stations)
        with torch.inference_mode():
            lo, hi = self.predictor.likelihood.cdf_bounds(raw, task.yt)
        lo, hi = lo.double().cpu().numpy(), hi.double().cpu().numpy()
        mask = np.broadcast_to(task.yt_mask.cpu().numpy().astype(bool)[..., None], lo.shape)
        rng = np.random.default_rng(seed)
        u = lo + rng.random(lo.shape) * np.maximum(hi - lo, 0.0)
        zfull = np.where(mask, ndtri(np.clip(u, 1e-6, 1.0 - 1e-6)), np.nan)
        out = _z_summary(zfull)
        if zfull.shape[-1] > 1:
            out["per_channel"] = {vid: _z_summary(zfull[..., c])
                                  for c, vid in enumerate(self.task_loader.target_var_IDs)}
        if return_samples:
            out["z"] = zfull[np.isfinite(zfull)]
        return out

    def crps(self, dates, remove_stations: Sequence[str] = (), n_samples: int = 64,
             seed: int = 0) -> dict:
        """Mean marginal CRPS at the targets in physical units, with the
        run's ``std_scale``: closed form for the Gaussian heads, the
        energy form over ``n_samples`` draws (a generator on the model's
        device seeded with ``seed``) for the mixed ones. CRPS is
        affine-equivariant, so the normalised score scales by each
        channel's |scale| (× 2 for humidity's unit-interval shift)."""
        task, raw = self._shipped_raw(dates, remove_stations)
        gen = torch.Generator(device=self.predictor.device).manual_seed(int(seed))
        with torch.inference_mode():
            c = self.predictor.likelihood.crps(raw, task.yt, gen, n_samples)
        c = c.double().cpu().numpy()
        scale, _ = self.predictor._affines()
        if self.run["variable"] == "humidity":
            scale = scale * 2.0
        c = c * np.abs(scale)
        c = np.where(task.yt_mask.cpu().numpy().astype(bool)[..., None], c, np.nan)
        out = {"crps": float(np.nanmean(c)), "n": int(np.isfinite(c).sum())}
        if c.shape[-1] > 1:
            out["per_channel"] = {vid: float(np.nanmean(c[..., ch]))
                                  for ch, vid in enumerate(self.task_loader.target_var_IDs)}
        return out

    def _target_station_coords(self) -> dict:
        """{station name or id, as a string: (lat, lon)} of every target
        station, unmapped from the target frame's x1/x2."""
        df = self.task_loader.target
        dp = self.run["data_processor"]
        lat = np.asarray(dp.unmap_x1(df["x1"]))
        lon = np.asarray(dp.unmap_x2(df["x2"]))
        out: dict = {}
        for name, la, lo in zip(df[_station_key(df)], lat, lon):
            out.setdefault(str(name), (float(la), float(lo)))
        return out

    def _region_predicate(self, lat_range=None, lon_range=None, elevation_range=None,
                          elevation_lookup=None):
        """(lat, lon) -> bool: inside the lat/lon box and/or the elevation
        band (bounds as in :meth:`elevation_band_errors`)."""
        if elevation_range is not None and elevation_lookup is None:
            elevation_lookup = registry_elevation_lookup()

        def inside(la: float, lo: float) -> bool:
            if lat_range is not None and not lat_range[0] <= la <= lat_range[1]:
                return False
            if lon_range is not None and not lon_range[0] <= lo <= lon_range[1]:
                return False
            if elevation_range is not None:
                e = elevation_lookup(la, lo)
                lo_e, hi_e = elevation_range
                if e is None or (lo_e is not None and e < lo_e) or (
                        hi_e is not None and e >= hi_e):
                    return False
            return True

        return inside

    def stations_in_region(self, lat_range=None, lon_range=None, elevation_range=None,
                           elevation_lookup=None) -> list:
        """Target-station names inside a lat/lon box and/or elevation band:
        the holdout sets of :meth:`extrapolation_loss`."""
        inside = self._region_predicate(lat_range, lon_range, elevation_range, elevation_lookup)
        return [name for name, (la, lo) in self._target_station_coords().items()
                if inside(la, lo)]

    def extrapolation_loss(self, dates, *, lat_range=None, lon_range=None,
                           elevation_range=None, elevation_lookup=None) -> dict:
        """Spatial-extrapolation holdout: every target station inside the
        region leaves the context at once; one prediction pass is scored at
        those stations (``extrapolation``) and at the rest
        (``interpolation``), each slot classified by its own coordinates."""
        held = self.stations_in_region(lat_range, lon_range, elevation_range, elevation_lookup)
        if not held:
            raise ValueError("no target stations inside the holdout region")
        loss = self.calculate_loss(dates, remove_stations=held)
        inside = self._region_predicate(lat_range, lon_range, elevation_range, elevation_lookup)
        dp = self.run["data_processor"]
        xt = loss["xt"]
        lat = np.asarray(dp.unmap_x1(xt[..., 0]))
        lon = np.asarray(dp.unmap_x2(xt[..., 1]))
        in_hold = np.fromiter((inside(la, lo) for la, lo in zip(lat.ravel(), lon.ravel())),
                              dtype=bool, count=lat.size).reshape(lat.shape)
        err = np.asarray(loss["errors"])
        sel = in_hold[..., None] if err.ndim == 3 else in_hold
        return {
            "held_out_stations": held,
            "extrapolation": _error_summary(np.where(sel, err, np.nan)),
            "interpolation": _error_summary(np.where(sel, np.nan, err)),
            "errors": err,
            "xt": xt,
            "holdout_mask": in_hold,
        }

    def wet_dry_skill(self, dates, base_field: Optional[Field] = None, station_df=None,
                      remove_stations: Sequence[str] = (), wet_threshold: float = 0.0) -> dict:
        """Occurrence skill of the bernoulli-gamma head at the stations: the
        Brier score and hit rate of P(wet) against observed wetness
        (> ``wet_threshold``, physical units), and with ``base_field`` and
        the raw ``station_df`` the base field's deterministic wetness as
        the baseline."""
        pred = self.get_predictions(dates, remove_stations)
        if "p_wet" not in pred:
            raise ValueError("wet/dry skill needs the bernoulli-gamma head (no P(wet) for "
                             f"likelihood {self.run['model'].cfg.likelihood!r})")
        obs = self._unnormalise_obs(pred["yt"])[..., 0]
        p = pred["p_wet"]
        mask = pred["mask"] & np.isfinite(p) & np.isfinite(obs)
        wet = (obs[mask] > wet_threshold).astype(np.float64)
        pm = p[mask]
        out = {
            "brier": float(np.mean((pm - wet) ** 2)) if mask.any() else np.nan,
            "hit_rate": float(np.mean((pm > 0.5) == (wet > 0.5))) if mask.any() else np.nan,
            "wet_frac_obs": float(np.mean(wet)) if mask.any() else np.nan,
            "n": int(mask.sum()),
        }
        if base_field is not None and station_df is not None:
            sdf = _rows_at_dates(_as_frame(station_df), dates)
            _, b, o = self._base_pairs_at_stations(base_field, sdf)
            bw = (b > wet_threshold).astype(np.float64)
            ow = (o > wet_threshold).astype(np.float64)
            out["baseline_brier"] = float(np.mean((bw - ow) ** 2)) if len(b) else np.nan
            out["baseline_hit_rate"] = float(np.mean(bw == ow)) if len(b) else np.nan
        return out

    @staticmethod
    def calibration_gate(stats: dict, z_std_range=(0.8, 1.25),
                         coverage_95_range=(0.90, 0.98)) -> bool:
        """True iff ``z_std`` and ``coverage_95`` of calibration (or PIT)
        stats lie inside their acceptance windows."""
        z = stats.get("z_std", np.nan)
        c = stats.get("coverage_95", np.nan)
        return bool(np.isfinite(z) and np.isfinite(c)
                    and z_std_range[0] <= z <= z_std_range[1]
                    and coverage_95_range[0] <= c <= coverage_95_range[1])

    def stations_in_date_range(self, station_df, date_range) -> list:
        """The stations (``station_name``, else ``station_id``, in sorted
        order) that report at or before the first and at or after the last
        date of ``date_range``."""
        station_df = _as_frame(station_df)
        col = station_df[_station_key(station_df)]
        lo, hi = np.datetime64(date_range[0]), np.datetime64(date_range[-1])
        t = station_df["time"].astype("datetime64[s]")
        names = []
        for name in np.unique(col):
            ts = t[col == name]
            if ts.min() <= lo and ts.max() >= hi:
                names.append(name)
        return names


class ValidateERA:
    """Operational gridded inference from raw base fields on the DEM grid."""

    def __init__(
        self,
        model_dir: Optional[str] = None,
        dem: Optional[Field] = None,
        highres_factor: int = 10,
        *,
        run: Optional[dict] = None,
        pred_grid: Optional[Field] = None,
        predictor: Optional[Predictor] = None,
        transfer_dtype: Optional[str] = None,
        batch_chunk: Optional[int] = None,
        download_threads: int = 1,
        upload_dtype: Optional[str] = None,
        device=None,
    ):
        """Load the run from ``model_dir`` onto ``device`` (``None``: the
        card), or reuse a loaded ``run`` (and its ``pred_grid`` and
        ``predictor``, as :class:`ValidateWRF` does). The prediction grid is
        the raw DEM coarsened by ``highres_factor``, NaN = sea.
        ``transfer_dtype``, ``batch_chunk``, ``download_threads`` and
        ``upload_dtype`` go to the :class:`Predictor`."""
        self.run = run or load_run(model_dir, device=device)
        self.dem = dem
        if pred_grid is None and dem is None:
            raise ValueError("ValidateERA needs a prediction grid: pass dem (coarsened by "
                             "highres_factor) or an explicit pred_grid")
        self.pred_grid = pred_grid if pred_grid is not None else dem.coarsen(highres_factor)
        self.predictor = predictor or Predictor(
            self.run["model"], self.run["data_processor"], self.run["task_loader"].target_var_IDs,
            transfer_dtype=transfer_dtype, std_scale=self.run.get("std_scale", 1.0),
            batch_chunk=batch_chunk, download_threads=download_threads,
            upload_dtype=upload_dtype)

    def _swapped_task(self, times, base_fields: dict, station_df=None,
                     remove_stations: Sequence[str] = (), context_sampling=None):
        """The loader's task at ``times`` with its data swapped for the raw
        ``base_fields`` and ``station_df`` (physical units, lat/lon
        coordinates), normalised with the run's processor: each base field
        resampled (nearest) onto the stored training grid, the time-of-year
        channels recomputed for ``times``, and an empty station context when
        ``station_df`` is None."""
        dp = self.run["data_processor"]
        tl = self.run["task_loader"]
        station_df = None if station_df is None else _as_frame(station_df)
        new_context = []
        for entry in tl.context:
            if isinstance(entry, StationFrame):
                if station_df is None:
                    new_context.append(entry.take([]))
                else:
                    sdf = remove_stations_from_frame(station_df, remove_stations)
                    new_context.append(dp(sdf, assert_computed=True))
                continue
            fields = dict(entry.items()) if isinstance(entry, Dataset) else {entry.name: entry}
            updated = dict(fields)
            for v, raw in base_fields.items():
                short = cfg.VAR_ERA5[v]["var_name"]
                if short in fields:
                    old = fields[short]
                    new_f = dp(raw.rename(short), assert_computed=True)
                    new_f = new_f._interp_one("x1", old.coords["x1"], "nearest")
                    updated[short] = new_f._interp_one("x2", old.coords["x2"], "nearest")
            circ_names = [n for n in fields if n in ("cos_D", "sin_D", "cos_H", "sin_H")]
            if circ_names:
                t_new = np.asarray(times, dtype="datetime64[s]")
                enc = circ_time_encoding(t_new, "H" if "cos_H" in circ_names else "D")
                for n in circ_names:
                    old = fields[n]
                    h, w = old.shape[-2:]
                    arr = np.broadcast_to(enc[n][:, None, None].astype(np.float32),
                                          (len(t_new), h, w)).copy()
                    coords = dict(old.coords)
                    coords["time"] = t_new
                    updated[n] = Field(arr, old.dims, coords, n, {})
            new_context.append(Dataset(updated))
        new_target = None
        if station_df is not None:
            new_target = dp(remove_stations_from_frame(station_df, remove_stations),
                            assert_computed=True)
        with tl.swap_data(context=new_context, target=new_target):
            return tl(list(np.asarray(times)), context_sampling=context_sampling,
                      seed_override=42)

    def predict(self, times: np.ndarray, base_fields: dict, station_df=None,
                remove_stations: Sequence[str] = (), context_sampling=None, n_samples: int = 0,
                outputs: tuple = ("mean", "std")):
        """Predict ``times`` on the DEM grid from raw ``base_fields``
        ({variable: Field}) and the raw ``station_df`` (see
        :meth:`_swapped_task`), with the loader's ``aux_at_targets``."""
        task = self._swapped_task(times, base_fields, station_df, remove_stations,
                                 context_sampling)
        return self.predictor.predict_grid(
            task, self.pred_grid, aux_at_targets=self.run["task_loader"].aux_at_targets,
            times=np.asarray(times), n_samples=n_samples,
            post_transform=post_transform_for(self.run["variable"]), outputs=outputs)


class ValidateWRF:
    """Forecast-cycle inference on the DEM grid coarsened by
    ``coarsen_factor``. The forecast files are read by the caller's source
    object: anything with ``load(filepaths, variables) -> {variable:
    Field}`` and ``regrid_to(field, lat, lon) -> Field``, as
    :class:`~..data.sources.wrf.WRFSource` has."""

    def __init__(self, model_dir: str, dem: Field, coarsen_factor: int = 5, device=None):
        self.run = load_run(model_dir, device=device)
        self.dem = dem
        self.pred_grid = dem.coarsen(coarsen_factor)
        self.coarsen_factor = coarsen_factor
        self._era = ValidateERA(run=self.run, dem=dem, pred_grid=self.pred_grid)
        self.predictor = self._era.predictor

    def predict(self, filepaths: Sequence[str], wrf_source, station_df=None,
                remove_stations: Sequence[str] = (), variables: Optional[Sequence[str]] = None):
        """One forecast cycle: load, regrid onto the prediction grid (K →
        °C where a temperature's mean is above 100), predict every
        forecast time through :meth:`ValidateERA.predict`."""
        var = self.run["variable"]
        raw = wrf_source.load(filepaths, list(variables or [var]))
        lat = self.pred_grid.coords["latitude"]
        lon = self.pred_grid.coords["longitude"]
        base_fields = {}
        for v, fld in raw.items():
            g = wrf_source.regrid_to(fld, lat, lon)
            if v == "temperature" and np.nanmean(g.data) > 100:
                g = g.copy(g.data - 273.15)
            base_fields[v] = g
        return self._era.predict(base_fields[var].coords["time"], base_fields,
                                 station_df=station_df, remove_stations=remove_stations)
