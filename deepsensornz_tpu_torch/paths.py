"""Machine-local data paths.

Counterpart of ``deepsensornz_tpu/paths.py``. The paths come from (in
priority order):

1. an explicit dict passed to :func:`set_data_paths`,
2. a JSON/YAML file pointed at by ``$DEEPSENSORNZ_PATHS``,
3. ``./data_paths.yaml`` or ``./data_paths.json`` in the CWD.

Expected keys mirror the reference layout::

    era5:       {parent, parent_processed}
    wrf:        {parent}
    stations:   {parent}
    topography: {file}
    save_model: {fpath}
    arguments:  {default, parent}
    cache:      <dir>
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

_DATA_PATHS: Optional[dict[str, Any]] = None


def set_data_paths(paths: dict[str, Any]) -> None:
    global _DATA_PATHS
    _DATA_PATHS = dict(paths)


def get_data_paths() -> dict[str, Any]:
    global _DATA_PATHS
    if _DATA_PATHS is not None:
        return _DATA_PATHS
    candidates = []
    env = os.environ.get("DEEPSENSORNZ_PATHS")
    if env:
        candidates.append(env)
    candidates += ["data_paths.yaml", "data_paths.yml", "data_paths.json"]
    for path in candidates:
        if os.path.exists(path):
            with open(path) as f:
                if path.endswith((".yaml", ".yml")):
                    import yaml

                    _DATA_PATHS = yaml.safe_load(f)
                else:
                    _DATA_PATHS = json.load(f)
            return _DATA_PATHS
    raise FileNotFoundError(
        "no data paths configured: call set_data_paths(), set "
        "$DEEPSENSORNZ_PATHS, or create data_paths.yaml"
    )
