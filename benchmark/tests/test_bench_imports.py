"""Nothing the benchmark runs imports JAX or the JAX package (compared by
whole top-level name), and the reference imports nothing of the port."""

import ast
import json
import subprocess
import sys

import pytest

from benchmark import manifest

FILES = sorted(p for p in manifest.HERE.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_whole_top_level_names():
    assert manifest.forbidden_loaded(["deepsensornz_tpu_torch", "deepsensornz_tpu_torch.ops",
                                      "jaxtyping", "flaxen", "numpy"]) == []
    assert manifest.forbidden_loaded(["deepsensornz_tpu.ops.grids", "jax", "jaxlib.xla_client",
                                      "flax.linen", "optax"]) == [
        "deepsensornz_tpu.ops.grids", "flax.linen", "jax", "jaxlib.xla_client", "optax"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(manifest.HERE)))
def test_no_file_of_the_benchmark_imports_jax(path):
    assert manifest.forbidden_loaded(list(_imports(path))) == []


@pytest.mark.parametrize("path", sorted((manifest.HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port_or_the_harness(path):
    names = [n.split(".", 1)[0] for n in _imports(path)]
    assert not {"deepsensornz_tpu_torch", "deepsensornz_tpu", "benchmark"} & set(names)


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh interpreter, then ``sys.modules``."""
    code = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(manifest.ROOT)!r})\n"
        "from benchmark import core\n"
        "from benchmark.tests.tiny import CPU, tiny_cell\n"
        "for w in ('serve-cycle.gnp-d500', 'train.gnp-d500'):\n"
        "    core.run_cell(tiny_cell(w), 7, 0.2, True, CPU, time.perf_counter())\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "deepsensornz_tpu_torch" in loaded
    assert manifest.forbidden_loaded(loaded) == []


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run([sys.executable, str(manifest.HERE / "run.py"), "--workload",
                          "serve-cycle.gnp-d500", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=manifest.ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
