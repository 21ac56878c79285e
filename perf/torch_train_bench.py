"""Time the flagship train step (``make_train_step``) on one NVIDIA GPU.

    python3 perf/torch_train_bench.py [--root DIR]

``--root`` is the checkout whose ``deepsensornz_tpu_torch`` is imported and
built (default: the one holding this script), so two commits can be timed
in one call on one card: run it for each, in turns. The inputs are
``chip_smoke.py``'s, from the checkout holding this script: ``[train]``'s
batch-8 task (the serving contexts, 512 station targets with one aux
channel, the 608x608 grid of density 500) and the flagship ConvNP (U-Net
(64,)*4, k=5, gnp rank 64, bf16 U-Net, random weights from seed 0), lr
5e-5. Prints one JSON line: the card's name and power limit
(``nvidia-smi``), the package, each of ``REPS`` steps' CUDA-event time and
wall time after ``WARMUP`` steps, their medians, and the last loss.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
WARMUP, REPS = 2, 10


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_train_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    sys.path.insert(0, args.root)  # the package under test, ahead of HERE's
    import deepsensornz_tpu_torch
    from deepsensornz_tpu_torch.models.convnp import ConvNPConfig
    from deepsensornz_tpu_torch.ops import _build
    from deepsensornz_tpu_torch.train.trainer import init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    cfg = ConvNPConfig(unet_channels=(64, 64, 64, 64), likelihood="gnp", internal_density=500,
                       rank=64, decoder_channels=64, mlp_hidden=64, kernel_size=5,
                       compute_dtype="bfloat16")
    task = cs.train_task(20, cs.N_TRAIN_TASKS, cfg.internal_density).to(dev)
    model = cs.build_model(cfg, task, seed=0, device=dev)
    state = init_state(model)
    step = make_train_step(model)
    ms, wall = [], []
    for i in range(WARMUP + REPS):
        (state, loss), t_ms, t_s = cs.timed(lambda: step(state, task, cs.TRAIN_LR))
        if i >= WARMUP:
            ms.append(t_ms)
            wall.append(t_s)
    print(json.dumps({"card": smi, "package": str(Path(deepsensornz_tpu_torch.__file__).parent),
                      "step_ms": ms, "step_s": wall, "median_ms": float(np.median(ms)),
                      "median_s": float(np.median(wall)), "loss": float(loss)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
