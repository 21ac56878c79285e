"""The port's health-check CLI (``deepsensornz_tpu_torch.cli.health``) on
the CPU (``--device cpu``), mirroring tests/test_health.py: the legs
measured, the JSON contract (the JAX report's keys), the budgets' exit
codes; and that without ``--device`` it wants the card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deepsensornz_tpu.cli.health import run_health as jrun_health
from deepsensornz_tpu_torch.cli.health import main, run_health

REPO = Path(__file__).resolve().parent.parent


def test_report_has_all_legs():
    r = run_health(reps=2, transfer_mb=0.5, device="cpu")
    for k in ("platform", "compile_s", "dispatch_ms_p50",
              "upload_mb_s", "download_mb_s"):
        assert k in r
    assert r["compile_s"] > 0 and r["dispatch_ms_p50"] > 0
    # the JAX report's keys, the platform named as JAX names the CPU
    want = jrun_health(reps=2, transfer_mb=0.5)
    assert r.keys() == want.keys()
    assert r["platform"] == want["platform"] == "cpu" and r["n_devices"] == 1


def test_quick_skips_transfer_and_gates(capsys):
    rc = main(["--quick", "--reps", "2", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip())
    assert rc == 0 and report["healthy"]
    assert "upload_mb_s" not in report

    rc = main(["--quick", "--reps", "2", "--max_compile_s", "1e-9", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip())
    assert rc == 1 and report["failed_legs"] == ["compile"]

    rc = main(["--reps", "2", "--transfer_mb", "0.5", "--min_transfer_mb_s", "1e12",
               "--max_dispatch_ms", "0", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip())
    assert rc == 1 and report["failed_legs"] == ["dispatch", "transfer"]


def test_wants_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_health(quick=True, reps=1)


def test_module_prints_one_json_line():
    proc = subprocess.run([sys.executable, "-m", "deepsensornz_tpu_torch.cli.health", "--quick",
                           "--reps", "2", "--device", "cpu"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["healthy"]
