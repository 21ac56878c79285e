"""Batch validation CLI.

    python -m deepsensornz_tpu_torch.cli.validate --var temperature \\
        --model_name model --year 2020 --months 1 2 3 [--device cpu]

Counterpart of ``deepsensornz_tpu/cli/validate.py``: each month is
predicted with stations held out, and scored at them (the nearest
prediction cell against each held-out observation); one prediction netCDF
per month and a JSON summary of the held-out RMSE and observation count
per month are written. The model runs on the card unless ``--device``
says otherwise. Reading the archives and writing netCDF need h5py.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from deepsensornz_tpu_torch.cli.infer import DEFAULT_HOLDOUT_STATIONS, month_hours
from deepsensornz_tpu_torch.infer.writer import save_prediction
from deepsensornz_tpu_torch.pipeline.validate import ValidateERA


def holdout_errors(pred, sdf_all, remove_stations) -> list[float]:
    """Prediction minus observation at every held-out station row whose
    nearest prediction cell and value are both finite."""
    holdout = sdf_all[np.isin(sdf_all["station_name"], list(remove_stations))]
    col = [c for c in holdout.columns if c.endswith("_station")]
    errs = []
    if not len(holdout) or not col:
        return errs
    for t, lat, lon, obs in zip(holdout["time"], holdout["latitude"], holdout["longitude"],
                                holdout[col[0]]):
        try:
            cell = pred["mean"].sel(time=np.datetime64(t), latitude=lat, longitude=lon,
                                    method="nearest")
        except (KeyError, IndexError, ValueError):
            continue
        if np.isfinite(cell.data) and np.isfinite(obs):
            errs.append(float(cell.data) - float(obs))
    return errs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--var", required=True)
    ap.add_argument("--model_name", required=True)
    ap.add_argument("--year", type=int, required=True)
    ap.add_argument("--months", type=int, nargs="*", default=None)
    ap.add_argument("--out_dir", default="validation")
    ap.add_argument("--highres_factor", type=int, default=10)
    ap.add_argument("--remove_stations", nargs="*", default=DEFAULT_HOLDOUT_STATIONS)
    ap.add_argument("--device", default=None,
                    help="torch device to predict on (default: the CUDA card)")
    ns = ap.parse_args(argv)

    from deepsensornz_tpu_torch.data.sources.era5 import ERA5Source
    from deepsensornz_tpu_torch.data.sources.stations import StationSource
    from deepsensornz_tpu_torch.data.sources.topography import topography_from_paths
    from deepsensornz_tpu_torch.paths import get_data_paths

    paths = get_data_paths()
    model_dir = os.path.join(paths["save_model"]["fpath"], ns.var, ns.model_name)
    dem = topography_from_paths(paths).load()
    validate = ValidateERA(model_dir, dem, highres_factor=ns.highres_factor, device=ns.device)
    era5 = ERA5Source(paths["era5"]["parent"])
    stations = StationSource(paths["stations"]["parent"])

    metrics = {}
    for month in ns.months or range(1, 13):
        hours = month_hours(ns.year, month)
        base = era5.load_time(ns.var, hours)
        sdf_all = stations.load_stations_time(ns.var, hours)
        pred = validate.predict(hours, {ns.var: base}, station_df=sdf_all,
                                remove_stations=ns.remove_stations)
        errs = holdout_errors(pred, sdf_all, ns.remove_stations)
        key = f"{ns.year}-{month:02d}"
        metrics[key] = {
            "holdout_rmse": float(np.sqrt(np.mean(np.square(errs)))) if errs else None,
            "n_holdout_obs": len(errs),
        }
        out_path = os.path.join(ns.out_dir, ns.var, ns.model_name,
                                f"val_{ns.var}_{ns.year:04d}_{month:02d}.nc")
        save_prediction(pred, out_path, ns.var, ns.model_name)
        print(f"{key}: rmse={metrics[key]}")

    summary = os.path.join(ns.out_dir, ns.var, ns.model_name, "metrics.json")
    with open(summary, "w") as f:
        json.dump(metrics, f, indent=2)
    print(f"wrote {summary}")


if __name__ == "__main__":
    main()
