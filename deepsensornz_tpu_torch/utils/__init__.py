"""Generic helpers: CLI argument validation/coercion, metrics.

Counterpart of ``deepsensornz_tpu/utils/__init__.py``: the typed YAML
argument validation of the training CLI and the ``rmse`` re-export (from
the port's ``data/features.py``).
"""

from deepsensornz_tpu_torch.data.features import rmse  # noqa: F401


def str2bool(v):
    """'true'/'false'/'1'/'0' → bool (``utils.py:217-227``)."""
    if isinstance(v, bool):
        return v
    if str(v).lower() in ("yes", "true", "t", "y", "1"):
        return True
    if str(v).lower() in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError(f"boolean value expected, got {v!r}")


def int_or_none(v):
    if v is None or str(v).lower() in ("none", "null", ""):
        return None
    return int(v)


def float_or_none(v):
    if v is None or str(v).lower() in ("none", "null", ""):
        return None
    return float(v)


def str_or_none(v):
    if v is None or str(v).lower() in ("none", "null", ""):
        return None
    return str(v)


def bool_or_float_or_str(v):
    """station_as_context coercion: bool / fraction / 'random' / 'split'
    (``utils.py:239-247``)."""
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    s = str(v).lower()
    if s in ("true", "false"):
        return s == "true"
    try:
        return float(s)
    except ValueError:
        if s in ("random", "split", "all"):
            return s
    raise ValueError(f"cannot coerce {v!r} to bool/float/str")


# per-argument coercer table for the training CLI YAML
ARG_SCHEMA = {
    "variable": str,
    "base": str,
    "model_name": str_or_none,
    "area": str_or_none,
    "train_start_year": int_or_none,
    "train_end_year": int_or_none,
    "val_start_year": int_or_none,
    "val_end_year": int_or_none,
    "year_step": int_or_none,
    # WRF-base training period (reference train_downscaling.py:74-94):
    # midnight-init cycle range YYYYMMDD, every time_intervals-th file
    "start_init": str_or_none,
    "end_init": str_or_none,
    "time_intervals": int_or_none,
    "era5_coarsen_factor": int_or_none,
    "highres_coarsen_factor": int_or_none,
    "lowres_coarsen_factor": int_or_none,
    "include_landmask": str2bool,
    "include_time_of_year": str2bool,
    "include_coordinates": str2bool,
    "station_as_context": bool_or_float_or_str,
    "batch_size": int_or_none,
    "lr": float_or_none,
    "weight_decay": float_or_none,
    "n_epochs": int_or_none,
    "unet_channels": lambda v: tuple(int(x) for x in v) if v else None,
    "top_kernel": int_or_none,
    # physical SetConv smoothing scale at init (normalised coords); None =
    # 2/internal_density + floor. Also accepts a per-scale mapping
    # {ls_decoder: 0.02, ...}
    "init_lengthscale": lambda v: (
        {str(k): float(x) for k, x in v.items()} if hasattr(v, "items")
        else float_or_none(v)),
    # post-Adam update multiplier on the ls_* params; 1 = reference parity
    "lengthscale_lr_mult": float_or_none,
    "likelihood": str_or_none,
    # recompute the U-Net in the backward (ConvNPConfig.remat) — fits big
    # internal grids / batches on one card; the port accepts remat_policy
    # and recomputes the whole U-Net whatever it says
    "remat": str2bool,
    "remat_policy": str_or_none,
    # 'tuned' / 'throughput' resolve per-variable density/length-scale
    # settings (config.PROFILES); 'parity'/null = reference defaults
    "profile": str_or_none,
    "internal_density": int_or_none,
    "auto_set_internal_density": str2bool,
    "pretrained_model": str_or_none,
    "remove_stations": lambda v: list(v) if v else [],
    "context_variables": lambda v: list(v) if v else [],
    "synthetic": str2bool,
}


def validate_and_convert_args(args: dict) -> dict:
    """Coerce + validate a YAML argument dict (``utils.py:249-271``).

    Unknown keys raise (typo guard); missing keys pass through as absent.
    """
    out = {}
    for k, v in args.items():
        if k not in ARG_SCHEMA:
            raise KeyError(f"unknown argument {k!r}; known: {sorted(ARG_SCHEMA)}")
        out[k] = ARG_SCHEMA[k](v)
    return out
