"""The port's timing and tracing utilities (``univst_torch.utils.profiling``)
on the CPU: ``device_trace`` with no directory does nothing,
``device_time_split`` reads a CPU-only trace (no device time: it says so
and reports no idle share) and sorts kernel names into their categories,
and ``sync`` returns host copies. What the split reads on the card is
measured by ``chip_smoke.py``'s ``[profile]`` phase; the span recorder's
tests are in ``test_torch_spans.py``."""

import os
from types import SimpleNamespace as NS

import pytest
import torch

from univst_torch.utils import profiling as tprof


def test_device_trace_without_a_directory_does_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with tprof.device_trace(None) as prof:
        torch.ones(4, 4) @ torch.ones(4, 4)
    assert prof is None and os.listdir(tmp_path) == []


def test_device_time_split_of_a_cpu_trace(tmp_path):
    with tprof.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / "trace" / "trace.json.gz") > 0
    split = tprof.device_time_split(prof)
    assert set(split["device_ms"]) == set(tprof.CATEGORIES)
    assert not split["device_time_seen"] and split["idle_share"] is None
    assert split["busy_ms"] == 0 and split["kernels"] == 0 and "note" in split
    assert split["norm_scoped_ms"] == 0
    assert split["wall_ms"] > 0


def test_annotate_norms_scopes_the_norm_modules(tmp_path):
    """Each norm module's forward runs inside one ``NORM_SCOPE`` range (and
    only while the annotation is active); other ops stay outside."""
    from univst_torch.models.layers import GroupNorm

    model = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.LayerNorm(8))
    gn = GroupNorm(8, 2)
    x = torch.ones(2, 8)
    with tprof.annotate_norms(model, gn), tprof.device_trace(str(tmp_path)) as prof:
        model(x)
        gn(x[:, :, None])
    events = prof.events()
    assert len([e for e in events if e.name == tprof.NORM_SCOPE]) == 2
    inside = {e.name for e in events if tprof._in_scope(e.cpu_parent, tprof.NORM_SCOPE)}
    assert "aten::layer_norm" in inside and "aten::var_mean" in inside
    assert "aten::linear" not in inside
    assert not model[1]._forward_hooks and not gn._forward_pre_hooks


class _Trace:
    """A recorded trace as ``device_time_split`` reads it: host ops, the
    kernels each launched, device kernels and the device-side span of a
    norm range (times in us)."""

    def __init__(self):
        cuda, cpu = "DeviceType.CUDA", "DeviceType.CPU"

        def ev(name, dev, t0, t1, parent=None, kernels=(), annotation=False):
            return NS(name=name, key=name, device_type=dev, time_range=NS(start=t0, end=t1),
                      cpu_parent=parent, kernels=[NS(name=k, duration=d) for k, d in kernels],
                      is_user_annotation=annotation)

        scope = ev(tprof.NORM_SCOPE, cpu, 0, 8)
        self._events = [
            scope, ev("aten::var_mean", cpu, 1, 5, scope, [("reduce_kernel", 10)]),
            ev("aten::mm", cpu, 9, 11, None, [("nvjet_tst_x", 20)]),
            ev("reduce_kernel", cuda, 10, 20), ev("nvjet_tst_x", cuda, 30, 50),
            ev("vfa_hopper_kernel<4, true>(CUtensorMap)", cuda, 52, 58),
            ev(tprof.NORM_SCOPE, cuda, 10, 60, annotation=True),
        ]

        def avg(name, dev, self_us):
            return NS(key=name, device_type=dev, self_device_time_total=self_us, count=1)

        self._avgs = [avg("reduce_kernel", cuda, 10), avg("nvjet_tst_x", cuda, 20),
                      avg("vfa_hopper_kernel<4, true>(CUtensorMap)", cuda, 6),
                      avg(tprof.NORM_SCOPE, cuda, 50), avg(tprof.NORM_SCOPE, cpu, 0),
                      avg("aten::var_mean", cpu, 10), avg("aten::mm", cpu, 20)]

    def events(self):
        return self._events

    def key_averages(self):
        return self._avgs


def test_device_time_split_arithmetic():
    """Kernels launched under a norm range count as norm, the range's own
    device span counts as no kernel, busy time is the union of the kernels'
    intervals and the span runs from the first event to the last."""
    split = tprof.device_time_split(_Trace())
    assert split["device_ms"]["norm"] == pytest.approx(0.010)
    assert split["device_ms"]["gemm"] == pytest.approx(0.020)
    assert split["device_ms"]["elementwise"] == 0 and split["norm_scoped_ms"] == pytest.approx(
        0.010)
    assert split["device_ms"]["k2"] == pytest.approx(0.006)
    assert split["vfa_calls_ms"] == [["k2", pytest.approx(0.006)]]
    assert split["kernels"] == 3 and split["busy_ms"] == pytest.approx(0.036)
    assert split["wall_ms"] == pytest.approx(0.060)
    assert split["idle_share"] == pytest.approx(0.4) and split["device_time_seen"]
    assert [o["op"] for o in split["top_ops"]] == ["aten::mm", "aten::var_mean"]


def test_kernel_names_sort_into_categories():
    """Kernel names as the profiler reported them on an H100 (cuBLASLt,
    cuDNN, PyTorch) and this repository's two kernels."""
    names = {
        "void vfa_hopper_kernel<192, false>(CUtensorMap, CUtensorMap)": "k1",
        "void vfa_hopper_kernel<128, true>(CUtensorMap, CUtensorMap)": "k2",
        "void vfa_kernel<true>(float const*, float const*)": "k2",
        "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x64": "sdpa",
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x64x32":
            "conv",
        "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>": "conv",
        "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT": "gemm",
        "void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<c10::BFloat16>":
            "norm",
        "void at::native::vectorized_layer_norm_kernel<c10::BFloat16, float>": "norm",
        "void at::native::elementwise_kernel<128, 4, CUDAFunctor_add<c10::BFloat16> >": (
            "elementwise"),
        "Memset (Device)": "other",
    }
    for name, cat in names.items():
        assert tprof.kernel_category(name) == cat, name


def test_sync_returns_host_copies():
    x = torch.arange(4.0)
    out = tprof.sync({"a": (x, [x * 2]), "n": 3})
    assert out["n"] == 3 and torch.equal(out["a"][0], x)
    assert out["a"][0].data_ptr() != x.data_ptr()
    assert torch.equal(out["a"][1][0], x * 2)
