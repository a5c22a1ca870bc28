"""BENCHMARK.json against the benchmark's contract, and every file it
names found where the harness looks."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= manifest["run_seconds"] <= 51 and isinstance(manifest["run_seconds"], int)
    assert all(PATH.match(p) and ".." not in p for p in manifest["paths"])
    assert len(manifest["command"]) <= 32 and all(_line(w) for w in manifest["command"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in manifest[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for e in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher"), e
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and _line(w["why"])
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(
        1, len(manifest["workloads"]) // 4)


def test_metrics(manifest):
    e2e = {e["name"]: e for e in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in e2e.values():
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in manifest["workloads"]}
    for c in cells:
        reported = [e["name"] for e in e2e.values() if c in e.get("workloads", [c])]
        assert "setup_s" in reported and len(reported) >= 2
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_file_the_cells_name(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    for w in manifest["workloads"]:
        cfg_file = configs[w["config"]]["file"]
        assert cfg_file.startswith("benchmark/")
        with open(os.path.join(ROOT, cfg_file)) as f:
            cfg = json.load(f)
        assert os.path.exists(os.path.join(ROOT, "benchmark", "systems", cfg["system"] + ".py"))
        for sub, name in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(ROOT, "benchmark", sub, name + ".json"))
        with open(os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json")) as f:
            kind = json.load(f)["kind"]
        assert os.path.exists(os.path.join(ROOT, "benchmark", "kinds", kind + ".py"))


def test_run_budget(manifest):
    """A full check of 24 cells at this run length fits the check's time."""
    r = manifest["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200
