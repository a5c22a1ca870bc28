"""``univst_torch/bench.py``, the port of ``bench.py`` and its family
scripts, on the CPU at its smoke size: the JSON line and its keys, the
refusal to run without a card unless the CPU is asked for, the card peak
table, the FLOP count against the JAX package's on one tiny stylization,
and the family lines with their phase-composed 50-step estimate.

The FLOP count is exact on both sides (integer products of shapes summed in
float64): the bar is a relative 1e-9.
"""

import json
import math
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import seeded_init
from univst_torch import bench

# bench.py's JSON line (bench.py:258-286)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
BENCH_EXTRA = {"baseline_fps_range", "vs_baseline_range", "inversion_steps_per_sec",
               "recon_latent_psnr_db", "stylize_run_s", "effective_tflops", "mfu"}
PORT_EXTRA = {"device", "peak_mem_gb", "stylize_runs_s", "k1_launches"}
# scripts/smoke_ad_tpu.py:79-83, scripts/smoke_sd3_tpu.py:112-118
FAMILY_KEYS = {"family", "size", "frames", "measured_steps", "ms_per_step",
               "frames_per_sec_50step"}


def _json_lines(out: str):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_cpu_smoke_prints_the_bench_line(capsys):
    assert bench.main(["--device", "cpu", "--repeats", "2"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == 1
    res = lines[0]
    assert set(res) == BENCH_KEYS
    assert set(res["extra"]) == BENCH_EXTRA | PORT_EXTRA
    ex = res["extra"]
    assert "CPU" in res["metric"] and ex["mfu"] is None
    assert ex["device"]["name"] == "cpu" and ex["k1_launches"] == 0
    assert len(ex["stylize_runs_s"]) == 2 and ex["stylize_run_s"] == min(ex["stylize_runs_s"])
    assert res["value"] == pytest.approx(4 / ex["stylize_run_s"])
    assert res["vs_baseline"] == pytest.approx(res["value"] / 1.05)
    assert ex["baseline_fps_range"] == [0.74, 1.05]
    for key in ("inversion_steps_per_sec", "recon_latent_psnr_db", "effective_tflops"):
        assert math.isfinite(ex[key]) and ex[key] > 0, key


def test_no_card_without_the_cpu_asked_for_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--repeats", "1"]) != 0
    err = capsys.readouterr()
    assert not _json_lines(err.out) and "no CUDA device" in err.err
    assert bench.main(["--family", "ad"]) != 0


def test_peak_table_names_an_unknown_card(monkeypatch):
    assert bench.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert bench.peak_tflops("NVIDIA H100 PCIe") == 756.0
    with pytest.raises(ValueError, match="TPU v5 lite"):
        bench.peak_tflops("TPU v5 lite")
    # the bench looks the peak up before it builds anything
    import univst_torch.pipelines.sd as sd

    monkeypatch.setattr(sd, "resolve_device", lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(bench, "device_info",
                        lambda device: {"name": "Some Card 48GB", "power_limit": "300.00 W",
                                        "count": 1})
    monkeypatch.setattr(sd.SDVideoPipeline, "build", lambda *a, **k: pytest.fail("built"))
    with pytest.raises(ValueError, match="Some Card 48GB"):
        bench.main([])


def test_flop_count_matches_the_jax_package():
    """One tiny stylization (4 frames, 64 px, 30 steps: 26 two-branch steps
    and 4 stylized-only) counted by the port's ``count_matmul_flops`` as it
    runs, and by the JAX package's over the traced jaxpr: the style
    pre-pass, both phases. At 64 px no attention reaches K1 (L = 64), so
    both count the same matmuls, convs and attentions. One thing more is in
    the JAX count: each loop segment resizes the mask to the latent grid
    once (univst_tpu/methods/style_transfer.py:28-32), and
    ``jax.image.resize`` does it as two ``dot_general``s, one per axis; the
    port's antialiased resize is no matmul. Those FLOPs, from shapes, come
    off the JAX count; the rest is equal."""
    from univst_tpu.core.config import StyleTransferConfig as JSTCfg
    from univst_tpu.pipelines.sd import SDVideoPipeline as JPipe
    from univst_tpu.utils.flops import count_matmul_flops as j_count
    from univst_torch.core.config import StyleTransferConfig
    from univst_torch.pipelines.sd import SDVideoPipeline
    from univst_torch.utils.flops import count_matmul_flops

    f, px, n = 4, 64, 30
    rng = np.random.default_rng(0)
    content = rng.standard_normal((n + 1, f, px // 8, px // 8, 4)).astype(np.float32)
    style = rng.standard_normal((n + 1, 1, px // 8, px // 8, 4)).astype(np.float32)
    init = rng.standard_normal((f, px // 8, px // 8, 4)).astype(np.float32)
    mask = (rng.uniform(size=(f, px, px)) > 0.5).astype(np.float32)

    with seeded_init(0):
        jp = JPipe.build(variant="tiny", num_frames=f, height=px, width=px, dtype=jnp.float32,
                         seed=0)
    jctx3 = jnp.concatenate([jp.encode_text("")] * 3)
    want = j_count(lambda c, s, i, ctx, m: jp.stylize_latents(c, s, i, ctx, mask=m,
                                                               cfg=JSTCfg(num_steps=n)),
                   jnp.asarray(content), jnp.asarray(style), jnp.asarray(init), jctx3,
                   jnp.asarray(mask))

    tp = SDVideoPipeline.build(variant="tiny", num_frames=f, dtype=torch.float32, device="cpu")
    tctx3 = torch.cat([tp.encode_text("")] * 3)
    got = count_matmul_flops(lambda: tp.stylize_latents(
        torch.tensor(content), torch.tensor(style), torch.tensor(init), tctx3,
        mask=torch.tensor(mask), cfg=StyleTransferConfig(num_steps=n)))
    h = px // 8
    resize = 2 * f * h * px * px + 2 * f * h * h * px  # rows, then columns
    assert want > 0 and got == pytest.approx(want - 2 * resize, rel=1e-9)  # 2 segments


@pytest.mark.parametrize("family,phase1_of_50", [("ad", 25), ("sd3", 31)])
def test_family_lines_and_their_50_step_estimate(family, phase1_of_50):
    """Each family through ``--families`` (a subprocess of ``--family``) on
    the CPU: the JAX script's keys, and the 50-step estimate equal to the
    two measured per-step rates weighted by the 50-step run's phase split."""
    got = bench.measure_families([family], "cpu", seed=0)[family]
    assert FAMILY_KEYS <= set(got) and ("variant" in got) == (family == "sd3")
    assert got["family"] == family and got["measured_steps"] == bench.FAMILY_STEPS[family]
    assert got["ms_per_step"] == got["phase1_ms_per_step"]
    assert got["phase1_steps_of_50"] == phase1_of_50
    p1, p2 = got["phase1_ms_per_step"] / 1e3, got["phase2_ms_per_step"] / 1e3
    assert p1 > 0 and p2 > 0
    est = phase1_of_50 * p1 + (50 - phase1_of_50) * p2
    assert got["est_50step_s"] == pytest.approx(est, rel=1e-12)
    assert got["frames_per_sec_50step"] == pytest.approx(got["frames"] / est, rel=1e-12)


def test_a_failing_family_fails_the_bench(monkeypatch):
    monkeypatch.setattr(bench, "family_command",
                        lambda family, device, seed: [sys.executable, "-c",
                                                      "import sys; sys.exit(3)"])
    with pytest.raises(RuntimeError, match="family ad failed"):
        bench.measure_families(["ad"], "cpu", seed=0)


def test_closed_window_runs_every_step_stylized_only():
    from univst_torch.core.config import AD_STYLE_SHIFT, SD3_STYLE_SHIFT, SD_STYLE_SHIFT

    for shift, end in ((SD_STYLE_SHIFT, 26), (AD_STYLE_SHIFT, 25), (SD3_STYLE_SHIFT, 31)):
        assert shift.window_end() == end
        assert bench.closed_window(shift).window_end() == 0
