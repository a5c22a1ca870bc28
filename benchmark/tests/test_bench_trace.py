"""The traced run's reduction, on a made-up trace: device operations are
tied to their launches, norm ranges and labelled video flash calls, and the
device readers read them."""

import pytest
import torch

from benchmark import roofline
from benchmark.metrics import elementwise_share, idle_share, k1_roofline, k2_roofline, norm_share
from benchmark.trace import (NORM_SCOPE, VFA_LABEL, WINDOW_SCOPE, DeviceTrace, decode_label,
                             encode_label, label_vfa_calls)

K1_Q = (2, 16, 8, 4096, 40)
K1_IDX = (-1, 0, "first")


class Ev:
    """The few methods of a profiler event that the reduction reads."""

    def __init__(self, name, start, end, dev=False, corr=0, link=0, user=False):
        self._name, self._s, self._e = name, start, end
        self.dev, self.corr, self.link, self.user = dev, corr, link, user

    def device_type(self):
        return "DeviceType.CUDA" if self.dev else "DeviceType.CPU"

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.link

    def is_user_annotation(self):
        return self.user


class Run:
    def __init__(self, trace):
        self.trace = trace


def _trace():
    label = VFA_LABEL + encode_label("k1", K1_Q, K1_Q, K1_IDX, 0)
    return DeviceTrace([
        Ev(WINDOW_SCOPE, 0, 1000),
        Ev(NORM_SCOPE, 100, 200),
        Ev("aten::group_norm", 150, 160, corr=6),
        Ev(label, 300, 400),
        Ev("univst::video_flash_attention", 305, 395, corr=5),
        Ev("aten::layer_norm", 600, 610, corr=7),
        Ev("aten::add", 800, 805, corr=8),
        Ev("aten::mul", 810, 815, corr=9),
        # the device side of the harness's range is no operation
        Ev(WINDOW_SCOPE, 0, 1000, dev=True, user=True),
        Ev("void group_norm_kernel<float>", 210, 250, dev=True, link=6),
        Ev("void vfa_kernel<false>(Params)", 500, 700, dev=True, link=5),
        Ev("void vectorized_layer_norm_kernel<float>", 710, 760, dev=True, link=7),
        Ev("void at::native::vectorized_elementwise_kernel<4>", 800, 900, dev=True, link=8),
        # a K1 kernel launched outside any labelled call is not matched
        Ev("void vfa_kernel<false>(Params)", 905, 915, dev=True, link=9),
    ])


def test_label_round_trip():
    label = encode_label("k2", (2, 16, 4429, 24, 64), (2, 16, 4096, 24, 64), ("first", -1, 0), 333)
    assert decode_label(label) == ("k2", ((2, 16, 4429, 24, 64), (2, 16, 4096, 24, 64),
                                          ("first", -1, 0), 333))


def test_reduction_and_device_readers():
    t = _trace()
    assert t.window == (0, 1000) and t.busy_ns() == 40 + 200 + 50 + 100 + 10
    assert [o[4] for o in t.ops] == [True, False, False, False, False]
    assert t.vfa_calls == {"k1": [((K1_Q, K1_Q, K1_IDX, 0), 200)], "k2": []}
    run = Run(t)
    busy = t.busy_ns()
    # the norm range's kernel and the functional layer norm outside it
    assert norm_share.read(run) == pytest.approx(100 * 90 / busy)
    assert elementwise_share.read(run) == pytest.approx(100 * 100 / busy)
    assert idle_share.read(run) == pytest.approx(100 * (1 - busy / 1000))
    bound = roofline.vfa_bound_s(*roofline.vfa_work(2, 16, 8, 4096, 4096, 40, K1_IDX))
    assert k1_roofline.read(run) == pytest.approx(100 * bound / 200e-9)
    assert k2_roofline.read(run) is None  # no K2 call: nothing to read
    assert t.breakdown()["device_ops"][0] == ["void vfa_kernel<false>(Params)", 210e-9]


def test_labels_carry_shapes_and_context(monkeypatch):
    """The wrappers pass their arguments and results through, keep their
    launch counters, and name each call's kernel, index set, shapes and
    context length in a profiler range."""
    import univst_torch.attention.video_flash as vf

    def fake(q, k, v, frame_indices, sm_scale=None, ctx_k=None, ctx_v=None, ctx_valid=None,
             tables=None):
        # as the program's wrappers count: on the module's attribute
        vf.video_flash_attention_tokens.launches += 1
        return q + 1

    fake.launches = 0
    monkeypatch.setattr(vf, "video_flash_attention_tokens", fake)
    q, k = torch.zeros(1, 2, 5, 2, 4), torch.zeros(1, 2, 3, 2, 4)
    ck = torch.zeros(1, 2, 7, 2, 4)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with label_vfa_calls():
            out = vf.video_flash_attention_tokens(q, k, k, ("first", -1), None, ck, ck)
            vf.video_flash_attention_tokens(q, k, k, ("first",), ctx_k=ck, ctx_v=ck, ctx_valid=6)
            vf.video_flash_attention_tokens(q, k, k, (0,))
    assert torch.equal(out, q + 1) and vf.video_flash_attention_tokens is fake
    assert fake.launches == 3
    labels = [decode_label(e.name()[len(VFA_LABEL):])
              for e in prof.profiler.kineto_results.events() if e.name().startswith(VFA_LABEL)]
    assert len(labels) == 3
    assert {(w, c[0], c[1]) for w, c in labels} == {("k2", tuple(q.shape), tuple(k.shape))}
    assert {c[2:] for _, c in labels} == {((0,), 0), (("first",), 6), (("first", -1), 7)}
