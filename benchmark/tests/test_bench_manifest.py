"""BENCHMARK.json against the contract's shape, and files found by name."""

import json
import shutil

import pytest

from benchmark import manifest

MAN = manifest.load_manifest()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(MAN) == TOP_KEYS
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + MAN["end_to_end"]
                         + MAN["per_layer"], ids=lambda e: e["name"])
def test_names_and_units_use_the_allowed_characters(entry):
    assert manifest.valid_name(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert manifest.valid_name(entry[key])
    if "unit" in entry:
        assert manifest.valid_unit(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_are_unique_and_references_resolve():
    cells = {w["name"] for w in MAN["workloads"]}
    configs = {c["name"] for c in MAN["configs"]}
    e2e = {m["name"] for m in MAN["end_to_end"]}
    names = [c["name"] for c in MAN["configs"]]
    assert len(names) == len(set(names)) and len(cells) == len(MAN["workloads"])
    assert len(e2e | {m["name"] for m in MAN["per_layer"]}) == len(MAN["end_to_end"]) + len(
        MAN["per_layer"])
    assert {w["config"] for w in MAN["workloads"]} == configs
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) == len(cells)
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_each_cell_resolves_and_reports_what_the_contract_asks(workload):
    cell = manifest.resolve(workload, MAN)
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer and all(m["moves"] in names for m in cell.per_layer)
    assert cell.chips == 1
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
    for m in cell.per_layer:
        assert callable(manifest.load_metric(m["name"]).read)


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_configuration_files_are_what_the_manifest_says(conf):
    data = json.loads((manifest.ROOT / conf["file"]).read_text())
    assert conf["file"] == f"benchmark/configs/{conf['name']}.json"
    assert data["reduced"] == conf["reduced"] == []
    assert data["source"] == conf["source"]


def _copy_tree(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(manifest.HERE, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return bench


def test_a_new_configuration_mix_cell_and_metric_need_no_edit(tmp_path):
    """Add one of each as new files and manifest entries: the loaders find
    them by name, and no file that was there changes."""
    bench = _copy_tree(tmp_path)
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    conf = json.loads((bench / "configs/convnp-gnp-d500.json").read_text())
    conf["model"]["internal_density"] = 350
    (bench / "configs/convnp-gnp-d350.json").write_text(json.dumps(conf))
    mix = json.loads((bench / "traffic/cycle24.json").read_text())
    mix["tasks_per_request"] = 48
    (bench / "traffic/cycle48.json").write_text(json.dumps(mix))
    (bench / "limits/serve-cycle48.gnp-d350.json").write_text(
        json.dumps({"moments_err": 3e-3, "sea_mismatch": 0}))
    (bench / "metrics/requests_traced.py").write_text(
        "def read(ctx):\n    return ctx.tasks or None\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "convnp-gnp-d350", "source": "s", "reduced": [],
                           "file": "benchmark/configs/convnp-gnp-d350.json", "why": "w"})
    man["workloads"].append({"name": "serve-cycle48.gnp-d350", "config": "convnp-gnp-d350",
                             "traffic": "cycle48", "chips": 1, "why": "w"})
    for m in man["end_to_end"]:
        if "workloads" in m and "serve-cycle.gnp-d500" in m["workloads"]:
            m["workloads"].append("serve-cycle48.gnp-d350")
    man["per_layer"].append({"name": "requests_traced", "unit": "tasks", "better": "higher",
                             "source": "program_counter", "layer": "model step",
                             "moves": "serve_tasks_per_s",
                             "workloads": ["serve-cycle48.gnp-d350"]})
    cell = manifest.resolve("serve-cycle48.gnp-d350", man, bench)
    assert cell.config["model"]["internal_density"] == 350
    assert cell.traffic["tasks_per_request"] == 48
    assert cell.limits == {"moments_err": 3e-3, "sea_mismatch": 0}
    assert [m["name"] for m in cell.end_to_end] == ["serve_tasks_per_s", "serve_ms_p95", "setup_s"]
    assert "requests_traced" in [m["name"] for m in cell.per_layer]
    assert manifest.load_metric("requests_traced", bench).read(type("C", (), {"tasks": 24})) == 24
    assert all(p.read_bytes() == b for p, b in before.items())


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        manifest.resolve("no-such-cell", MAN)
    with pytest.raises(ValueError):
        manifest.load_config("../etc")
    with pytest.raises(FileNotFoundError):
        manifest.load_metric("no_such_metric")


def test_a_per_layer_metric_must_list_its_workloads():
    man = json.loads(json.dumps(MAN))
    del man["per_layer"][0]["workloads"]
    with pytest.raises(KeyError, match="lists no workloads"):
        manifest.resolve(MAN["workloads"][0]["name"], man)
