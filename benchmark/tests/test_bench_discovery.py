"""A configuration, a traffic mix of a new kind and a per-layer metric added
as new files, with manifest entries, are found by name; nothing else
changes."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBE = r"""
import json, sys
from benchmark.run import Cell, RunRecord
import importlib
c = Cell("sd15_other")
r = RunRecord(c)
r.spans["stylize"] = [2.0, 4.0]
vals = {m["name"]: importlib.import_module("benchmark.metrics." + m["name"]).read(r)
        for m in c.per_layer}
from benchmark import traffic
inputs = traffic.input_set(c.traffic, 4, 7, 0, "cpu")
print(json.dumps({"config": c.config["name"], "steps": c.traffic["steps"],
                  "inputs": {k: list(v.shape) for k, v in inputs.items()},
                  "still": bool((inputs["init"] == inputs["init"][0]).all()),
                  "system": c.system.__name__, "limits": c.limits, "metrics": vals}))
"""


def test_new_files_are_found(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "sd15.json").read_text())
    cfg["name"] = "sd15_copy"
    (b / "configs" / "sd15_copy.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "stylize_512_f16_s50.json").read_text())
    traffic.update(steps=30, kind="stylize_still")
    (b / "traffic" / "stylize_512_f16_s30.json").write_text(json.dumps(traffic))
    (b / "kinds" / "stylize_still.py").write_text(
        "from benchmark.kinds import stylize\n\n"
        "def input_set(traffic, latent_channels, gen, device):\n"
        "    d = stylize.input_set(traffic, latent_channels, gen, device)\n"
        "    d['init'] = d['init'][:1].expand_as(d['init']).clone()\n"
        "    return d\n")
    (b / "limits" / "sd15_other.json").write_text(json.dumps({"latent_gap": 1.0}))
    (b / "metrics" / "twice_stylize_s.py").write_text(
        "def read(run):\n    s = run.spans.get('stylize')\n    return 2 * max(s) if s else None\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "sd15_copy", "source": "https://example.org", "reduced": [],
                         "file": "benchmark/configs/sd15_copy.json", "why": "a copy"})
    m["workloads"].append({"name": "sd15_other", "config": "sd15_copy", "chips": 1,
                           "traffic": "stylize_512_f16_s30", "why": "30 steps"})
    m["per_layer"].append({"name": "twice_stylize_s", "unit": "s", "better": "lower",
                           "source": "host_clock", "layer": "pipelines",
                           "moves": "frames_per_s", "workloads": ["sd15_other"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]))
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["config"] == "sd15_copy" and out["steps"] == 30 and out["still"]
    assert out["inputs"] == {"content": [31, 16, 64, 64, 4], "style": [31, 1, 64, 64, 4],
                             "init": [16, 64, 64, 4], "mask": [16, 512, 512]}
    assert out["system"] == "benchmark.systems.sd" and out["limits"] == {"latent_gap": 1.0}
    assert out["metrics"]["twice_stylize_s"] == 8.0 and out["metrics"]["stylize_s"] == 3.0
    assert out["metrics"]["norm_share"] is None  # no trace: nothing to read
    assert "k1_roofline" not in out["metrics"]  # listed for its own cells only
