"""Operational inference CLI.

    python -m deepsensornz_tpu_torch.cli.infer --var temperature \\
        --model_name model --year 2020 [--device cpu]

Counterpart of ``deepsensornz_tpu/cli/infer.py``: for each month of the
year, every hour is predicted on the DEM grid from the ERA5 base and the
station archive with the standard 9-station holdout, stripped to the mean
and written as one compressed netCDF with provenance attributes per month,
so that a stopped year resumes at the month that failed (an existing
month's file is skipped). The data paths come from ``paths``; the model
runs on the card unless ``--device`` says otherwise. Reading the archives
and writing netCDF need h5py.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from deepsensornz_tpu_torch.infer.writer import save_prediction
from deepsensornz_tpu_torch.pipeline.validate import ValidateERA

# the standard held-out stations of operational validation, spread over NZ
DEFAULT_HOLDOUT_STATIONS = [
    "auckland_aero", "wellington_aero", "christchurch_aero",
    "dunedin_aero", "queenstown_aero", "hokitika_aero",
    "napier_aero", "taupo_aero", "invercargill_aero",
]


def month_hours(year: int, month: int) -> np.ndarray:
    """Every hour of a month, as ``datetime64[h]``."""
    start = np.datetime64(f"{year:04d}-{month:02d}-01", "h")
    end = (np.datetime64(f"{year + 1:04d}-01-01", "h") if month == 12
           else np.datetime64(f"{year:04d}-{month + 1:02d}-01", "h"))
    return np.arange(start, end, np.timedelta64(1, "h"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--var", required=True)
    ap.add_argument("--model_name", required=True)
    ap.add_argument("--year", type=int, required=True)
    ap.add_argument("--months", type=int, nargs="*", default=None)
    ap.add_argument("--out_dir", default="outputs")
    ap.add_argument("--highres_factor", type=int, default=10)
    ap.add_argument("--remove_stations", nargs="*", default=DEFAULT_HOLDOUT_STATIONS)
    ap.add_argument("--transfer_dtype", default="int16",
                    help="device->host dtype of the prediction maps: 'int16' (default), "
                         "'int8', 'float16', 'bfloat16' or 'none' (float32)")
    ap.add_argument("--batch_chunk", type=int, default=24,
                    help="tasks per forward: bounds device memory for month-long batches "
                         "and lets downloads overlap the later chunks")
    ap.add_argument("--download_threads", type=int, default=8,
                    help="host threads that copy, dequantise and scatter the chunks")
    ap.add_argument("--upload_dtype", default="float16",
                    help="host->device dtype of the task's value leaves (coordinates stay "
                         "float32, compute is float32): 'float16' (default), 'bfloat16' or "
                         "'none'")
    ap.add_argument("--fetch_std", action="store_true",
                    help="also download the std maps (the written product is the mean only)")
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
    tdt = None if ns.transfer_dtype in ("none", "") else ns.transfer_dtype
    udt = None if ns.upload_dtype in ("none", "") else ns.upload_dtype
    validate = ValidateERA(model_dir, dem, highres_factor=ns.highres_factor,
                           transfer_dtype=tdt, batch_chunk=ns.batch_chunk,
                           download_threads=ns.download_threads, upload_dtype=udt,
                           device=ns.device)
    era5 = ERA5Source(paths["era5"]["parent"])
    stations = StationSource(paths["stations"]["parent"])

    months = list(ns.months or range(1, 13))
    t_start, n_done = time.time(), 0
    for i, month in enumerate(months):
        out_path = os.path.join(ns.out_dir, ns.var, ns.model_name,
                                f"{ns.var}_{ns.year:04d}_{month:02d}.nc")
        if os.path.exists(out_path):
            print(f"skip existing {out_path}")
            continue
        hours = month_hours(ns.year, month)
        base = era5.load_time(ns.var, hours)
        sdf = stations.load_stations_time(ns.var, hours)
        pred = validate.predict(hours, {ns.var: base}, station_df=sdf,
                                remove_stations=ns.remove_stations,
                                outputs=("mean", "std") if ns.fetch_std else ("mean",))
        save_prediction(pred, out_path, ns.var, ns.model_name, mean_only=True,
                        attrs={"year": ns.year, "month": month})
        n_done += 1
        eta = (time.time() - t_start) / n_done * (len(months) - i - 1)
        print(f"wrote {out_path}  [{i + 1}/{len(months)} months, eta {eta / 60.0:.1f} min]",
              flush=True)


if __name__ == "__main__":
    main()
