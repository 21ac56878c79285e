"""Training CLI: ``python -m deepsensornz_tpu_torch.cli.train_downscaling -arg_path args.yaml``.

Counterpart of ``deepsensornz_tpu/cli/train_downscaling.py``:

- a YAML argument file with typed validation
  (:func:`deepsensornz_tpu_torch.utils.validate_and_convert_args`) and the
  ``profile:`` key resolved by :func:`..config.apply_profile`,
- the YAML archived into the model directory,
- the data processor reused from ``{model_dir}/../data_processor.json``
  where one exists, else fitted,
- :class:`~..pipeline.preprocess.PreprocessForDownscaling` →
  :class:`~..pipeline.train.Train` (loader, ConvNP with the variable's
  default likelihood, ``top_kernel``, ``init_lengthscale``, ``remat``,
  ``remat_policy``) → ``train_model``, writing ``params.pt``,
  ``params.msgpack``, ``opt_state.pt``, ``metadata.json``,
  ``task_loader.pkl`` and ``data_processor.json`` under
  ``{save_model}/{variable}/{model_name}/``.

``synthetic: true`` runs the whole pipeline on generated NZ-like data;
otherwise :func:`load_real_data` reads the ERA5 or WRF base, the DEM and
the station archive of the data paths (netCDF, through h5py). Training
runs on the card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import os
import shutil

import yaml

from deepsensornz_tpu_torch import config as cfg
from deepsensornz_tpu_torch.data.processor import DataProcessor
from deepsensornz_tpu_torch.pipeline.preprocess import PreprocessForDownscaling
from deepsensornz_tpu_torch.pipeline.train import Train
from deepsensornz_tpu_torch.utils import validate_and_convert_args


def load_real_data(args):
    """The training inputs from the on-disk archives of the data paths:
    ``(base_fields, dem, stations, wrf_source)``. The ERA5 base reads the
    year files from ``train_start_year`` to ``val_end_year`` (else
    ``train_end_year``) every ``year_step`` years, with daily stations;
    ``base: wrf`` reads the midnight cycles ``start_init``..``end_init``,
    every ``time_intervals``-th hourly file, with hourly stations, and
    returns the :class:`WRFSource` that ``run_processing_sequence``
    regrids with (else None). Needs h5py."""
    from deepsensornz_tpu_torch.data.sources.era5 import ERA5Source
    from deepsensornz_tpu_torch.data.sources.stations import StationSource
    from deepsensornz_tpu_torch.data.sources.topography import topography_from_paths
    from deepsensornz_tpu_torch.paths import get_data_paths

    paths = get_data_paths()
    variable = args["variable"]
    context_vars = list(dict.fromkeys([variable] + args.get("context_variables", [])))
    wrf_source = None
    if args.get("base") == "wrf":
        from datetime import datetime

        from deepsensornz_tpu_torch.data.sources.wrf import WRFSource

        wrf_source = WRFSource(paths["wrf"]["parent"])
        start = datetime.strptime(str(args["start_init"]), "%Y%m%d")
        end = datetime.strptime(str(args.get("end_init") or args["start_init"]), "%Y%m%d")
        fpaths = wrf_source.get_filepaths(start, end)
        fpaths = fpaths[:: args.get("time_intervals") or 1]
        if not fpaths:
            raise FileNotFoundError(
                f"no WRF files for inits {args['start_init']}..{args.get('end_init')} "
                f"under {paths['wrf']['parent']}")
        base_fields = wrf_source.load(fpaths, context_vars)
    else:
        years = list(range(args.get("train_start_year", 2000),
                           args.get("val_end_year", args.get("train_end_year", 2001)) + 1,
                           args.get("year_step") or 1))
        era5 = ERA5Source(paths["era5"]["parent"])
        base_fields = {v: era5.load(v, years) for v in context_vars}
    base = base_fields[variable]
    dem = topography_from_paths(paths).load(area=args.get("area"))
    stations = StationSource(paths["stations"]["parent"]).load_stations_time(
        variable, base.coords["time"],
        # WRF matches stations at the cycle files' hourly stamps; ERA5 is daily
        daily=args.get("base") != "wrf",
        remove_stations=args.get("remove_stations", []))
    return base_fields, dem, stations, wrf_source


def load_synthetic_data(args):
    from deepsensornz_tpu_torch.data.synthetic import synthetic_bundle

    return synthetic_bundle(
        variable=args["variable"], n_times=24, base_hw=(24, 24),
        dem_hw=(96, 96), n_stations=24,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-arg_path", "--arg_path", required=True,
                    help="YAML arguments file")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA card)")
    ns = ap.parse_args(argv)
    with open(ns.arg_path) as f:
        raw_args = yaml.safe_load(f)
    args = cfg.apply_profile(validate_and_convert_args(raw_args))

    variable = args["variable"]
    model_name = args.get("model_name") or "model"
    try:
        from deepsensornz_tpu_torch.paths import get_data_paths

        save_root = get_data_paths().get("save_model", {}).get("fpath", "models")
    except FileNotFoundError:
        save_root = "models"
    model_dir = os.path.join(save_root, variable, model_name)
    os.makedirs(model_dir, exist_ok=True)
    shutil.copy(ns.arg_path, os.path.join(model_dir, "args.yaml"))

    wrf_source = None
    if args.get("synthetic"):
        base, dem, stations = load_synthetic_data(args)
        base_fields = {variable: base}
    else:
        base_fields, dem, stations, wrf_source = load_real_data(args)

    # data-processor reuse-or-create
    dp_path = os.path.join(model_dir, "..", "data_processor.json")
    data_processor = DataProcessor.load(dp_path) if os.path.exists(dp_path) else None

    pre = PreprocessForDownscaling(
        variable=variable, base=args.get("base", "era5"), area=args.get("area"),
    )
    processed = pre.run_processing_sequence(
        dem, base_fields, stations,
        highres_factor=args.get("highres_coarsen_factor") or 10,
        lowres_factor=args.get("lowres_coarsen_factor") or 50,
        coarsen_factor=args.get("era5_coarsen_factor") or 1,
        include_landmask=args.get("include_landmask", False),
        include_time_of_year=args.get("include_time_of_year", True),
        include_coordinates=args.get("include_coordinates", False),
        data_processor=data_processor,
        wrf_source=wrf_source,
        test_norm=True,
    )

    training = Train(processed, device=ns.device)
    training.setup_task_loader(
        station_as_context=args.get("station_as_context", "all"),
        internal_density=args.get("internal_density"),
        auto_set_internal_density=args.get("auto_set_internal_density", False),
    )
    training.initialise_model(
        unet_channels=args.get("unet_channels") or cfg.CONVNP_KWARGS_DEFAULT["unet_channels"],
        likelihood=args.get("likelihood") or cfg.LIKELIHOODS[variable],
        pretrained_dir=args.get("pretrained_model"),
        top_kernel=args.get("top_kernel"),
        init_lengthscale=args.get("init_lengthscale"),
        **({"remat": args["remat"]} if args.get("remat") is not None else {}),
        **({"remat_policy": args["remat_policy"]}
           if "remat_policy" in args else {}),
    )
    result = training.train_model(
        n_epochs=args.get("n_epochs") or cfg.TRAIN_DEFAULTS["n_epochs"],
        batch_size=args.get("batch_size") or cfg.TRAIN_DEFAULTS["batch_size"],
        lr=args.get("lr") or cfg.TRAIN_DEFAULTS["lr"],
        weight_decay=args.get("weight_decay") or cfg.TRAIN_DEFAULTS["weight_decay"],
        model_dir=model_dir,
        # 0.0 is meaningful (no Adam step on the ls params), so None, not
        # falsiness, selects the default
        lengthscale_lr_mult=(1.0 if args.get("lengthscale_lr_mult") is None
                             else args["lengthscale_lr_mult"]),
    )
    print(f"best val loss: {result['best_val']:.4f}; artifacts in {model_dir}")
    return model_dir


if __name__ == "__main__":
    main()
