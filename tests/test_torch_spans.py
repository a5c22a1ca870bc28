"""The port's span recorder (``univst_torch.utils.profiling``: ``SPANS``,
``spans``) on the CPU, and the benchmark's reading of its spans
(``benchmark/spans.py``).

Off, a span site records nothing and opens no profiler range. In events
mode a tiny SD or SD3 ``stylize_latents`` whose steps reach phase 2 gives
one ``stylize`` root with its pre-pass (SD) and phase segments as children
and one step span per step, with the step indices of ``phase_segments``;
on the CPU no span has a device time. In ranges mode the spans are
``univst::`` profiler ranges, nested as the spans are, and each video flash
attention call names its shapes and index set in a range that the
benchmark's ``decode_label`` reads. The latents are the same bit for bit in
every mode. What the spans read on the card is measured by
``python3 benchmark/spans.py`` on a card."""

import dataclasses
from types import SimpleNamespace as NS

import _torch_parity  # noqa: F401  (gives this worker's torch its share of the cores)
import pytest
import torch

from benchmark import spans as bspans
from benchmark.trace import decode_label
from univst_torch.core.config import SD3_STYLE_SHIFT, StyleTransferConfig
from univst_torch.pipelines.segments import phase_segments
from univst_torch.utils import profiling
from univst_torch.utils.profiling import SPANS, Span, spans

CPU = torch.device("cpu")
STEPS = 6  # with the shift window cut to steps 0-3: phase 1 is 4 steps, phase 2 two


def _inputs(channels=4):
    from univst_torch.bench import synthetic_inputs

    return synthetic_inputs(CPU, STEPS, 2, 64, 1, channels=channels)


@pytest.fixture(scope="module")
def sd():
    from univst_torch.pipelines.sd import SDVideoPipeline

    pipe = SDVideoPipeline.build(variant="tiny", num_frames=2, dtype=torch.float32, seed=0,
                                 device="cpu")
    content, style, init, mask = _inputs()
    context3 = torch.cat([pipe.encode_text("")] * 3)
    shift = dataclasses.replace(pipe.style_shift_cfg, eta2=0.06)

    def run():
        return pipe.stylize_latents(content, style, init, context3, mask=mask,
                                    cfg=StyleTransferConfig(num_steps=STEPS), style_cfg=shift)

    return NS(run=run, pipe=pipe, segments=phase_segments(STEPS, shift.window_end()),
              prepass=True)


@pytest.fixture(scope="module")
def sd3():
    from univst_torch.pipelines.sd3 import SD3VideoPipeline

    pipe = SD3VideoPipeline.build(variant="tiny", num_frames=2, dtype=torch.float32, seed=0,
                                  device="cpu")
    content, style, init, mask = _inputs(pipe.vae.cfg.latent_channels)
    context, pooled = pipe.encode_prompt("")
    context3, pooled3 = torch.cat([context] * 3), torch.cat([pooled] * 3)
    shift = dataclasses.replace(SD3_STYLE_SHIFT, eta2=0.06)

    def run():
        return pipe.stylize_latents(content, style, init, content[0], context3, pooled3,
                                    mask=mask, cfg=StyleTransferConfig(num_steps=STEPS),
                                    style_cfg=shift)

    return NS(run=run, pipe=pipe, segments=phase_segments(STEPS, shift.window_end()),
              prepass=False)


def _check_tree(got, segments, prepass):
    """One ``stylize`` root and job; its children the pre-pass (SD) and the
    phase segments in order; under each segment one step span per step,
    with the step index as ``i``; every span inside its parent's host
    interval; no device time on the CPU."""
    phase1, phase2 = segments
    assert phase1 and phase2
    roots = [s for s in got if s.name == "stylize"]
    assert len(roots) == 1 and roots[0].parent is None
    root = roots[0]
    assert {s.job for s in got} == {root.id}
    by_id = {s.id: s for s in got}
    children = sorted((s for s in got if s.parent == root.id), key=lambda s: s.host_start_ns)
    want = (["prepass"] if prepass else []) + ["phase1"] * len(phase1) + ["phase2"] * len(phase2)
    assert [s.name for s in children] == want
    segs = [s for s in children if s.name.startswith("phase")]
    for s, (s0, c) in zip(segs, phase1 + phase2):
        assert s.attrs == {"start": s0, "steps": c}
        steps = sorted((x for x in got if x.parent == s.id), key=lambda x: x.host_start_ns)
        assert [x.name for x in steps] == ["step"] * c
        assert [x.attrs["i"] for x in steps] == list(range(s0, s0 + c))
    assert len(got) == 1 + prepass + len(segs) + STEPS
    for s in got:
        assert s.device_ms is None
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.host_start_ns <= s.host_start_ns <= s.host_end_ns <= p.host_end_ns


def test_off_records_nothing_and_opens_no_range(sd, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span site did more than check the flag")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(SPANS, "span", refuse)
    assert not SPANS.on
    sd.run()
    assert SPANS.take() == []


@pytest.mark.parametrize("name", ["sd", "sd3"])
def test_events_mode_gives_the_job_tree(name, request):
    p = request.getfixturevalue(name)
    with spans(events=True):
        p.run()
    assert not SPANS.on
    _check_tree(SPANS.take(), p.segments, p.prepass)
    assert SPANS.take() == []


@pytest.mark.parametrize("name", ["sd", "sd3"])
def test_latents_equal_in_every_mode(name, request):
    p = request.getfixturevalue(name)
    off = p.run()
    with spans(events=True):
        events = p.run()
    with spans(events=False, ranges=True):
        ranges = p.run()
    SPANS.take()
    assert torch.equal(off, events) and torch.equal(off, ranges)


def test_ranges_nest_under_the_profiler(sd, tmp_path):
    """``device_trace`` turns the ranges on: the step ranges sit in the
    phase ranges, one per step, and the phases in the ``stylize`` range."""
    with profiling.device_trace(str(tmp_path)) as prof:
        assert SPANS.ranges and not SPANS.events
        sd.run()
    assert not SPANS.on and SPANS.take() == []
    pr = bspans.ProgramRanges(prof.profiler.kineto_results.events())
    names = [r[2] for r in pr.ranges]
    assert names.count("stylize") == 1 and names.count("prepass") == 1
    (s0, c1), (_, c2) = sd.segments[0][0], sd.segments[1][0]
    assert len(pr.steps("phase1")) == c1 and len(pr.steps("phase2")) == c2
    assert names.count("step") == c1 + c2
    for i, (s, t, name) in enumerate(pr.ranges):
        parent = pr.parent[i]
        want = {"stylize": None, "prepass": "stylize", "phase1": "stylize",
                "phase2": "stylize", "step": ("phase1", "phase2")}[name]
        if want is None:
            assert parent is None
        else:
            assert pr.ranges[parent][2] in want
            assert pr.ranges[parent][0] <= s and t <= pr.ranges[parent][1]


@pytest.mark.parametrize("which", ["k1", "k2"])
def test_vfa_range_names_the_call(which):
    """In ranges mode each wrapper call opens ``univst::vfa <label>``, whose
    label ``benchmark.trace.decode_label`` reads back to the kernel, the q
    and k shapes, the index set and the context length; off, none."""
    from univst_torch.attention import video_flash as vf

    g = torch.Generator().manual_seed(0)
    if which == "k1":  # [B, F, H, L, dh]
        q, k = torch.randn(1, 3, 2, 8, 8, generator=g), torch.randn(1, 3, 2, 6, 8, generator=g)
        fn, indices, kw, ctx_valid = vf.video_flash_attention, (-1, 0, "first"), {}, 0
    else:  # [B, F, L, H, dh], with a context of 5 tokens, 4 of them valid
        q, k = torch.randn(1, 3, 8, 2, 8, generator=g), torch.randn(1, 3, 6, 2, 8, generator=g)
        ctx = torch.randn(1, 3, 5, 2, 8, generator=g)
        fn, indices, ctx_valid = vf.video_flash_attention_tokens, ("first", -1), 4
        kw = dict(ctx_k=ctx, ctx_v=ctx, ctx_valid=ctx_valid)

    def labels():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = fn(q, k, k, indices, **kw)
        return out, [e.name()[len(profiling.VFA_RANGE):]
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(profiling.VFA_RANGE)]

    plain, none = labels()
    with spans(events=False, ranges=True):
        out, got = labels()
    assert none == [] and torch.equal(out, plain)
    assert [decode_label(x) for x in got] == [
        (which, (tuple(q.shape), tuple(k.shape), indices, ctx_valid))]


def test_roots_and_nesting():
    """A span outside a root records nothing (in ranges mode it still opens
    its range); a root opens a job that its children share; ``spans`` and
    ``device_trace`` give the flags back as they found them."""
    with spans(events=True):
        with SPANS.span("step", i=3):
            with SPANS.span("phase1"):
                pass
        assert SPANS.take() == []
        with SPANS.span("decode", device=CPU) as d:
            with SPANS.span("step", i=0):
                pass
        with spans(events=False, ranges=True):
            assert SPANS.on and SPANS.ranges and not SPANS.events
        assert SPANS.on and SPANS.events and not SPANS.ranges
        with profiling.device_trace(None):
            assert not SPANS.ranges
    assert not SPANS.on
    got = SPANS.take()
    assert [(s.name, s.job, s.parent) for s in got] == [("step", d.id, d.id),
                                                       ("decode", d.id, None)]
    assert got[0].attrs == {"i": 0} and got[1].device_ms is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans(events=True, ranges=True), SPANS.span("step", i=1):
            pass
    assert SPANS.take() == []
    assert [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith(profiling.RANGE_PREFIX)] == ["univst::step"]


def test_device_time_split_skips_the_program_ranges():
    """The device side of a span range is no kernel, and the host side of
    one is no host op in ``top_ops``."""
    cuda, cpu = "DeviceType.CUDA", "DeviceType.CPU"

    def ev(name, dev, t0, t1):
        return NS(name=name, key=name, device_type=dev, time_range=NS(start=t0, end=t1),
                  cpu_parent=None, kernels=[], is_user_annotation=False)

    def avg(name, dev, us):
        return NS(key=name, device_type=dev, self_device_time_total=us, count=1)

    step, vfa = "univst::step", profiling.vfa_range("k1", (1, 2, 1, 4, 4), (1, 2, 1, 4, 4),
                                                    (-1,), 0)
    events = [ev(step, cpu, 0, 100), ev("aten::mm", cpu, 5, 10), ev("nvjet_tst_x", cuda, 20, 40),
              ev(step, cuda, 20, 90), ev(vfa, cuda, 50, 60)]
    trace = NS(events=lambda: events,
               key_averages=lambda: [avg("nvjet_tst_x", cuda, 20), avg(step, cuda, 70),
                                     avg(vfa, cuda, 10), avg(step, cpu, 70),
                                     avg("aten::mm", cpu, 20)])
    split = profiling.device_time_split(trace)
    assert split["kernels"] == 1 and split["busy_ms"] == pytest.approx(0.020)
    assert split["device_ms"]["gemm"] == pytest.approx(0.020)
    assert sum(split["device_ms"].values()) == pytest.approx(0.020)
    assert [o["op"] for o in split["top_ops"]] == ["aten::mm"]


# -- the benchmark's readings ------------------------------------------------------------


def _span(name, id, parent, ms, job=0, **attrs):
    return Span(name, id, job, parent, attrs, 0, 1, ms)


def test_step_times_from_the_spans():
    """Mean device ms of the steps under each phase and of the pre-pass,
    steps per job; None without spans or without device times."""
    got = [_span("stylize", 0, None, None), _span("prepass", 1, 0, 120.0),
           _span("phase1", 2, 0, 500.0), _span("step", 3, 2, 150.0, i=0),
           _span("step", 4, 2, 160.0, i=1), _span("phase2", 5, 0, 160.0),
           _span("step", 6, 5, 80.0, i=2), _span("step", 7, 5, 70.0, i=3),
           _span("decode", 8, None, None, job=8)]
    assert bspans.step_ms(got, "phase1") == pytest.approx(155.0)
    assert bspans.step_ms(got, "phase2") == pytest.approx(75.0)
    assert bspans.prepass_ms(got) == pytest.approx(120.0)
    assert bspans.steps_per_job(got, "phase2") == 2
    cpu = [s._replace(device_ms=None) for s in got]
    for spans_ in ([], cpu):
        assert bspans.step_ms(spans_, "phase1") is None and bspans.prepass_ms(spans_) is None
    assert bspans.steps_per_job([], "phase1") == 0


class Ev:
    """The few methods of a profiler event that the reduction reads (as in
    ``benchmark/tests/test_bench_trace.py``)."""

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


def test_launches_busy_and_idle_by_range():
    """Device operations belong to the innermost range open at their launch:
    launches and busy time a phase-2 step, and the idle gaps totalled by
    that range."""
    vfa = profiling.vfa_range("k1", (1, 2, 1, 4, 4), (1, 2, 1, 4, 4), (-1,), 0)
    events = [
        Ev("benchmark::clip", 0, 1000),
        Ev("univst::stylize", 0, 900),
        Ev("univst::phase1", 10, 300), Ev("univst::step", 20, 290),
        Ev("aten::mm", 30, 40, corr=1),
        Ev("univst::phase2", 300, 890),
        Ev("univst::step", 310, 590), Ev("aten::add", 320, 330, corr=2),
        Ev(vfa, 400, 500), Ev("univst::video_flash_attention", 410, 490, corr=3),
        Ev("univst::step", 600, 880), Ev("aten::mul", 610, 620, corr=4),
        Ev("aten::copy_", 950, 960, corr=5),
        # the device side of the ranges is no operation
        Ev("univst::step", 320, 580, dev=True, user=True),
        Ev("nvjet_tst_x", 50, 250, dev=True, link=1),
        Ev("void at::native::elementwise_kernel<4>", 350, 380, dev=True, link=2),
        Ev("void vfa_kernel<false>(Params)", 500, 560, dev=True, link=3),
        Ev("void at::native::elementwise_kernel<4>", 700, 720, dev=True, link=4),
        Ev("Memcpy DtoH (Device -> Pinned)", 960, 970, dev=True, link=5),
    ]
    pr = bspans.ProgramRanges(events)
    assert pr.window == (0, 1000) and len(pr.ops) == 5
    assert len(pr.steps("phase1")) == 1 and len(pr.steps("phase2")) == 2
    assert pr.launches_per_step("phase2") == pytest.approx(1.5)
    assert pr.busy_ms_per_step("phase2") == pytest.approx((30 + 60 + 20) / 2 / 1e6)
    assert pr.launches_per_step("phase1") == 1
    gaps = pr.idle_gaps()
    assert gaps == pytest.approx({"phase1/step": 50 / 1e9, "phase2/step": (100 + 140) / 1e9,
                                  "phase2/vfa": 120 / 1e9, "(none)": 240 / 1e9,
                                  "(after the last operation)": 30 / 1e9})
    assert pr.seconds("phase2") == pytest.approx(590 / 1e9)
    empty = bspans.ProgramRanges([Ev("aten::mm", 0, 1, corr=1)])
    assert empty.launches_per_step("phase2") is None and empty.busy_ms_per_step("phase2") is None
    assert empty.idle_gaps() == {}


def test_spans_script_needs_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bspans.main(["--workload", "sd15_stylize", "--seed", "1"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
