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

``synthetic: true`` runs the whole pipeline on generated NZ-like data.
The on-disk archives (netCDF through h5py) are not ported yet, so any
other run raises. Training runs on the card unless ``--device`` says
otherwise.
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
    """The JAX package reads the ERA5 or WRF base, the DEM and the station
    archives from disk here. Those readers are not ported yet: raises."""
    raise NotImplementedError(
        "training from the on-disk archives is not ported yet: the ERA5 and WRF "
        "readers (data/sources/era5.py, data/sources/wrf.py), the station archive "
        "(data/sources/stations.py) and the topography (data/sources/topography.py) "
        "need the netCDF I/O of data/grid.py (h5py); use synthetic: true, or train "
        "with the JAX package's CLI"
    )


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
