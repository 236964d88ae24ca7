"""The manifest against the benchmark's contract, and the files it names."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head", "expansion")


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest(ROOT)


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= manifest["run_seconds"] <= 51 and isinstance(manifest["run_seconds"], int)
    assert len(json.dumps(manifest)) <= 64 * 1024
    assert manifest["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w for w in manifest["command"])


def test_entry_keys_and_names(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or w in k for k in c["reduced"]
                       for w in WIDTH_WORDS)
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [x["name"] for x in manifest["configs"]]
    names_w = [x["name"] for x in manifest["workloads"]]
    names_m = [x["name"] for x in manifest["end_to_end"] + manifest["per_layer"]]
    for seq in (names, names_w, names_m):
        assert len(seq) == len(set(seq))
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_what_it_must(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for cell in manifest["workloads"]:
        ends = [m["name"] for m in harness.metrics_of(manifest, cell, trace=False)]
        layers = harness.metrics_of(manifest, cell, trace=True)
        assert "setup_s" in ends and len(ends) >= 2 and layers
        for m in layers:
            # the metric it moves is reported in each of its cells
            assert m["moves"] in ends, (cell["name"], m["name"])
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_files_found_by_name(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for cell in manifest["workloads"]:
        config = harness.config_of(manifest, cell, ROOT)
        assert config["name"] == cell["config"] and config["reduced"] == []
        harness.reference_of(config)
        driver = harness.driver_of(harness.traffic_of(cell))
        assert hasattr(driver, "Cell") and driver.LIMITS in config["limits"]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert callable(harness.reader_of(m["name"]))


def test_file_names_are_names():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
