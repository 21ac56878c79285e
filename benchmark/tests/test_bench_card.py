"""On the card (``cuda`` marker; skips without one): a short traced run of
each cell through ``run.py`` prints one result line, correct, with its
per-layer metrics, the shares of peaks and rooflines within 100 %."""

import json
import subprocess
import sys

import pytest

from benchmark import manifest

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_traced_run_on_the_card(workload, card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
                          str(2**31 + 21), "--seconds", "4", "--trace", "1"],
                         capture_output=True, text=True, timeout=600, cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    cell = manifest.resolve(workload, manifest.load_manifest())
    assert set(result["metrics"]) == {m["name"] for m in cell.per_layer}
    for name, m in result["metrics"].items():
        if name.startswith(("mfu", "b1", "b2")):
            assert 0 < m["value"] <= 100, (name, m)
    assert list(result)[-1] == "check"
