"""Nothing a cell's run loads is JAX, Flax or the JAX package, compared by
whole top-level names."""

import os
import subprocess
import sys

from benchmark.run import FORBIDDEN, forbidden_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBE = r"""
import json, sys, torch
from benchmark.run import run_cell, forbidden_modules
from benchmark.tests import tiny
for name in ("sd15_stylize", "sd3m_stylize"):
    c = tiny.cell(name)
    c.traffic.update(steps=2, warmup_steps=2)
    run_cell(c, 5, 0.1, False, torch.device("cpu"), log=lambda m: None)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
print(json.dumps(forbidden_modules()))
"""


def test_a_run_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    top, found = (__import__("json").loads(x) for x in res.stdout.strip().splitlines()[-2:])
    assert "univst_torch" in top and found == []
    assert not set(top) & set(FORBIDDEN)


def test_names_compare_whole(monkeypatch):
    before = forbidden_modules()
    for name in ("univst_tpu_notes", "jaxlike", "flaxen.x", "univst_torch.x"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert forbidden_modules() == before
    if "univst_tpu" not in before:
        monkeypatch.setitem(sys.modules, "univst_tpu.models", sys)
        assert forbidden_modules() == sorted(before + ["univst_tpu"])
