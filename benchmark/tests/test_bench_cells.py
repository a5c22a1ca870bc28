"""Each cell driven through the harness at its tiny size on the CPU (the
run's look for a card skipped): correct against the reference, and not
correct with the timed path broken underneath or with the control in the
program's place."""

import pytest
import torch

from benchmark.run import gaps, judge, run_cell
from benchmark.tests import tiny

CPU = torch.device("cpu")
CELLS = sorted(tiny.TINY)


def _run(cell, seed=1234567890123, trace=False):
    return run_cell(cell, seed, 0.2, trace, CPU, log=lambda m: None)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name):
    cell = tiny.cell(name)
    res = _run(cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {e["name"] for e in cell.end_to_end}
    assert list(res)[-1] == "check"
    assert set(res["check"]) == set(cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run(name):
    cell = tiny.cell(name)
    res = _run(cell, seed=77, trace=True)
    # the untraced window's jobs, then the traced one
    assert res["correct"] and res["attempted"] >= 2
    assert res["metrics"]["stylize_s"]["value"] > 0 and res["metrics"]["decode_s"]["value"] > 0
    assert res["metrics"]["mfu"]["value"] > 0
    # no device on the CPU: nothing for the device readers
    assert not {"idle_share", "k1_roofline", "k2_roofline", "norm_share"} & set(res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", CELLS)
def test_warmup_runs_the_traffics_warmup_steps(monkeypatch, name):
    cell = tiny.cell(name)
    tr = dict(cell.traffic, warmup_steps=3)
    cls = cell.system.System
    seen, orig = [], cls.stylize

    def stylize(self, inputs, traffic, steps=None):
        seen.append(steps)
        return orig(self, inputs, traffic, steps)

    monkeypatch.setattr(cls, "stylize", stylize)
    system = cls(cell.config, tr, CPU, 5)
    from benchmark import traffic as traffic_mod

    system.warmup(traffic_mod.input_set(tr, cell.system.latent_channels(cell.config), 5, 0, CPU),
                  tr)
    assert seen == [3]


def _state_unchanged(monkeypatch, name):
    """A denoising step that returns its state unchanged."""
    if name == "sd15_stylize":
        from univst_torch.core.scheduler import DDIMSchedule

        monkeypatch.setattr(DDIMSchedule, "step", lambda self, eps, t, sample, n: sample)
    else:
        import univst_torch.pipelines.sd3 as sd3

        monkeypatch.setattr(sd3, "style_transfer_rf_steps",
                            lambda denoise, content, style, latents, *a, **k: latents)


def _half_batch(monkeypatch, system_cls):
    """Half of the clip's frames left out, each replaced by the mean of the
    rest."""
    orig = system_cls.stylize

    def stylize(self, inputs, traffic, *a):
        lat = orig(self, inputs, traffic, *a).clone()
        h = lat.shape[0] // 2
        lat[h:] = lat[:h].mean(0, keepdim=True)
        return lat

    monkeypatch.setattr(system_cls, "stylize", stylize)


def _answer_altered(monkeypatch, system_cls):
    """One frame altered where the frames are produced."""
    orig = system_cls.decode

    def decode(self, latents, traffic):
        frames = orig(self, latents, traffic).clone()
        frames[-1] = 255 - frames[-1]
        return frames

    monkeypatch.setattr(system_cls, "decode", decode)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(monkeypatch, name, fault):
    """The faults a stylization job can have. (One card: there is no
    exchange between chips to leave out.)"""
    cell = tiny.cell(name)
    if fault == "state_unchanged":
        _state_unchanged(monkeypatch, name)
    elif fault == "half_batch":
        _half_batch(monkeypatch, cell.system.System)
    else:
        _answer_altered(monkeypatch, cell.system.System)
    res = _run(cell, seed=99)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("control", ["fp8", "bf16_stats"])
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, control):
    """Each control in the program's place, the reference with its products
    through float8 or its norms, AdaIN and schedulers in bfloat16, fails the
    cell's limits (bf16 weights, as the configuration states)."""
    from benchmark import traffic as traffic_mod

    cell = tiny.cell(name, dtype="bfloat16")
    cfg, tr, sysmod = cell.config, cell.traffic, cell.system
    tr["steps"] = 50 if name == "sd15_stylize" else 28
    inputs = traffic_mod.input_set(tr, sysmod.latent_channels(cfg), 3, 0, CPU)
    ref = sysmod.reference_clip(cfg, tr, inputs, 3, CPU)
    ctl = sysmod.reference_clip(cfg, tr, inputs, 3, CPU, control=control)
    assert not judge(gaps(*ctl, *ref), cell.limits)
