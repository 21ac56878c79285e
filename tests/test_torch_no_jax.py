"""The port runs where JAX does not exist.

A machine with an NVIDIA card may have no jax, flax or the JAX package.
These tests block those imports in a fresh interpreter, then import every
module of ``deepsensornz_tpu_torch`` and ``chip_smoke`` and serve a tiny
gridded request on the CPU. The kernel module must also import without
``nvcc``: the kernels are built at first use on the card.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_BLOCKED = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "deepsensornz_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
"""

_SERVE = _BLOCKED + """
import importlib, pkgutil
import numpy as np
import deepsensornz_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke as cs
from deepsensornz_tpu_torch.models.convnp import ConvNPConfig
from deepsensornz_tpu_torch.infer.predict import Predictor
from deepsensornz_tpu_torch.ops import setconv_cuda
dp = cs.make_processor("t")
dem, aux = cs.target_fields(dp, (20, 18), seed=0)
cfg = ConvNPConfig(unet_channels=(8, 8), internal_density=30, rank=4, decoder_channels=8,
                   mlp_hidden=8, compute_dtype="float32")
task = cs.cycle_task(0, 2, cfg.internal_density, base_hw=(9, 8), aux_hw=(20, 18), n_stations=12)
model = cs.build_model(cfg, task, seed=0, device="cpu")
setconv_cuda.reset_launch_counts()
pred = Predictor(model, dp, "t").predict_grid(task, dem, aux_at_targets=aux)
cs.check_prediction(pred, dem, 2)
assert setconv_cuda.launch_counts() == {"encode_offgrid": 0, "decode_grid": 0}
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "deepsensornz_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("modules", len(names))
"""


def _run(code: str):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    # a PATH without the CUDA toolkit, as on a machine without nvcc
    env.update(PYTHONPATH=str(REPO), PATH="/usr/bin:/bin")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_and_serves_without_jax():
    proc = _run(_SERVE)
    assert proc.returncode == 0, proc.stderr
    assert "modules" in proc.stdout


def test_kernel_module_imports_without_nvcc():
    proc = _run(_BLOCKED + """
import shutil
assert shutil.which("nvcc") is None
from deepsensornz_tpu_torch.ops import setconv_cuda, _build
assert setconv_cuda.launch_counts() == {"encode_offgrid": 0, "decode_grid": 0}
try:
    _build.find_nvcc()
except RuntimeError:
    print("no nvcc")
""")
    assert proc.returncode == 0, proc.stderr
    assert "no nvcc" in proc.stdout or Path("/usr/local/cuda/bin/nvcc").exists()


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """Without CUDA (and alone, without the port) chip_smoke fails and
    prints no result."""
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                              text=True, timeout=300,
                              env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
