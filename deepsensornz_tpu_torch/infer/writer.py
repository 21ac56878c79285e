"""Prediction output writer: compressed netCDF with provenance.

Counterpart of ``deepsensornz_tpu/infer/writer.py``: a ``Prediction``
written as float32, gzip-compressed, chunked netCDF with the standard
provenance attributes (institution, source, author, creation time, the
script), one file per month in the operational CLI so that a long job
resumes at the month that failed. Needs h5py (``data.grid.save_dataset``).
"""

from __future__ import annotations

import datetime
import getpass
import os
import sys

from deepsensornz_tpu_torch.data.grid import Dataset, save_dataset

STANDARD_ATTRS = {
    "institution": "Bodeker Scientific",
    "source": "deepsensornz_tpu ConvNP downscaling",
}


def standard_metadata(extra: dict | None = None) -> dict:
    """Provenance attributes, updated by ``extra``."""
    meta = dict(STANDARD_ATTRS)
    meta["author"] = getpass.getuser()
    meta["created"] = datetime.datetime.now(datetime.timezone.utc).isoformat()
    meta["script"] = os.path.abspath(sys.argv[0]) if sys.argv else ""
    meta.update(extra or {})
    return meta


def save_prediction(prediction: Dataset, path: str, variable: str,
                    model_name: str = "", attrs: dict | None = None,
                    mean_only: bool = False, packing: str | None = None) -> None:
    """Write a prediction to netCDF with the provenance attributes (and
    ``variable``, ``model_name`` and ``attrs``) on the file; ``mean_only``
    keeps the ``mean`` variable alone; ``packing="int16"`` writes CF-packed
    int16 variables (``save_dataset``). The attributes are also set on
    ``prediction``, as the JAX writer sets them."""
    out = prediction
    if mean_only:
        out = Dataset({"mean": prediction["mean"]}, dict(prediction.attrs))
    out.attrs.update(standard_metadata(
        {"variable": variable, "model_name": model_name, **(attrs or {})}))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_dataset(out, path, compress=True, float32=True, packing=packing)
