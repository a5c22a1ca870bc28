"""Multi-process fixtures of the port's frame-parallel tests: run a function
on N gloo ranks on the CPU, each in a process of its own.

Each rank is a ``torch.multiprocessing`` spawn child (never a fork of a
process that holds threads) that joins a process group over a ``file://``
store under the test's ``tmp_path`` (no TCP port that could collide across
pytest-xdist workers), with one torch thread and a process-group timeout of
:data:`PG_TIMEOUT_S`. :func:`run_ranks` returns every rank's result; a rank
that raises or dies fails the test at once (the others are killed) and a
rank that hangs fails it after :data:`JOIN_S`, so no case can hang the
suite.

The rank functions live here, not in the test files, so that a child
imports torch and the port only (no JAX). Their arguments are numpy arrays
and state dicts the parent made.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

PG_TIMEOUT_S = 90  # a collective that waits longer raises
JOIN_S = 180  # the whole multi-process case


def _entry(fn, rank, n, outdir, args, n_tensor=1):
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist

        from univst_torch.distributed.mesh import make_mesh

        dist.init_process_group("gloo", init_method=f"file://{outdir}/store", rank=rank,
                                world_size=n, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        out = fn(make_mesh(n_tensor=n_tensor, device="cpu"), *args)
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(outdir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise SystemExit(1)


def run_ranks(fn, n: int, tmp_path, *args, timeout: float = JOIN_S, mesh_tensor: int = 1):
    """``fn(mesh, *args)`` on ``n`` gloo ranks, a mesh of ``n / mesh_tensor``
    data ranks by ``mesh_tensor`` tensor ranks; returns the list of their
    results (rank order)."""
    outdir = str(tmp_path)
    os.makedirs(outdir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, n, outdir, args, mesh_tensor))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    try:
        while time.time() < deadline and any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break  # one rank failed: the others would wait for it
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    errs = [open(os.path.join(outdir, f"rank{r}.err")).read() for r in range(n)
            if os.path.exists(os.path.join(outdir, f"rank{r}.err"))]
    if errs:
        raise AssertionError("a rank failed:\n" + "\n".join(errs))
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"ranks did not finish within {timeout}s "
                             f"(exit codes {[p.exitcode for p in procs]})")
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


# --------------------------------------------------------------------------
# rank functions
# --------------------------------------------------------------------------


def mesh_basics(mesh, x):
    """shard_frames / gather_frames / replicate on a ``[F, ...]`` array."""
    from univst_torch.distributed.mesh import (
        gather_frames, replicate, replicate_input, shard_frames,
    )

    xt = torch.tensor(x)
    local = shard_frames(xt, mesh, axis=1)
    whole = gather_frames(local, mesh, axis=1)
    single = shard_frames(xt[:, :1], mesh, axis=1)  # does not divide: replicated
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(mesh.rank))  # each rank draws its own
    replicate(lin, mesh)
    y = replicate_input(mesh, torch.full((2,), float(mesh.rank)))
    return local, whole, single, lin.weight.clone(), y


def gather_on_request(mesh, frames):
    """A tiny pipeline with ``gather=False``: encode returns the rank's
    shard, the decode takes it and returns the rank's frames."""
    from univst_torch.distributed.mesh import gather_frames

    pipe = _tiny_pipe(None, "sd", None, frames.shape[0]).with_mesh(mesh, gather=False)
    gen = torch.Generator().manual_seed(0)
    z = pipe.encode_frames(frames, gen)
    px = pipe.decode_latents(z)
    return z, px, gather_frames(z, mesh), gather_frames(px, mesh)


def inflated_unet(mesh, x, t: int):
    """The inflated SD UNet (``temporal_identity=False``: temporal convs and
    temporal attention, seeded random weights) on this rank's frames of
    ``x`` [F, h, w, 4], gathered, with the census."""
    from univst_torch.distributed.census import collect_collectives
    from univst_torch.distributed.comm import FrameShard
    from univst_torch.distributed.mesh import gather_frames, shard_frames
    from univst_torch.models.layers import VideoCtx

    unet, ctx = inflated_unet_model()
    shard = FrameShard.of(mesh, x.shape[0])
    vctx = VideoCtx(num_frames=shard.local, shard=shard)
    with torch.inference_mode(), collect_collectives() as recs:
        eps, _ = unet(shard_frames(torch.tensor(x), mesh), t, ctx, vctx)
    return gather_frames(eps, mesh), recs


def inflated_unet_model():
    from univst_torch.models.unet_sd import UNetPseudo3D, UNetSDConfig
    from univst_torch.pipelines.sd import random_init_

    unet = UNetPseudo3D(UNetSDConfig.tiny(temporal_identity=False)).eval()
    random_init_(unet, torch.Generator().manual_seed(0))
    return unet, torch.randn(1, 77, 32, generator=torch.Generator().manual_seed(1))


def group_norm(mesh, x, groups: int, num_frames: int):
    """The frame-spanning GroupNorm on this rank's frames of ``x`` ([B*F, C,
    H, W], frames within each of the B videos), gathered."""
    from univst_torch.distributed.comm import FrameShard
    from univst_torch.distributed.mesh import gather_frames
    from univst_torch.models.layers import GroupNorm

    shard = FrameShard.of(mesh, num_frames)
    gn = GroupNorm(x.shape[1], groups, across_frames=True)
    xt = torch.tensor(x).reshape((-1, num_frames) + x.shape[1:])
    local = xt[:, shard.offset:shard.offset + shard.local].reshape((-1,) + x.shape[1:])
    out = gn(local, shard.local, shard).reshape((-1, shard.local) + x.shape[1:])
    return gather_frames(out, mesh, axis=1).reshape(x.shape)


def video_mha(mesh, cases, heads: int, num_frames: int):
    """``ops.video_mha``'s shard form on each case ``(q, k, v, indices)`` of
    ``[B*F, L, D]`` arrays: per case the gathered output and this rank's
    collective census."""
    from univst_torch.attention import ops
    from univst_torch.distributed.census import collect_collectives
    from univst_torch.distributed.comm import FrameShard
    from univst_torch.distributed.mesh import gather_frames

    shard = FrameShard.of(mesh, num_frames)

    def local(a):
        t = torch.tensor(a).reshape((-1, num_frames) + a.shape[1:])
        return t[:, shard.offset:shard.offset + shard.local].reshape((-1,) + a.shape[1:])

    res = []
    for q, k, v, indices in cases:
        with collect_collectives() as recs:
            out = ops.video_mha(local(q), local(k), local(v), heads, shard.local, indices,
                                shard=shard)
        out = out.reshape((-1, shard.local) + q.shape[1:])
        res.append((gather_frames(out, mesh, axis=1).reshape(q.shape), recs))
    return res


def latent_adain(mesh, cnt, sty):
    from univst_torch.core.adain import latent_adain as adain
    from univst_torch.distributed.comm import FrameShard
    from univst_torch.distributed.mesh import gather_frames, shard_frames

    shard = FrameShard.of(mesh, cnt.shape[0])
    out = adain(shard_frames(torch.tensor(cnt), mesh), shard_frames(torch.tensor(sty), mesh),
                shard)
    return gather_frames(out, mesh)


def vae_decode(mesh, state, z, num_frames: int):
    """The tiny temporal VAE's decode of ``z`` [F, h, w, 4], sharded."""
    from univst_torch.distributed.comm import FrameShard
    from univst_torch.distributed.mesh import gather_frames, shard_frames
    from univst_torch.models.vae import AutoencoderKL, VAEConfig

    vae = AutoencoderKL(VAEConfig.tiny(temporal_decoder=True)).eval()
    vae.load_state_dict(state, strict=True)
    shard = FrameShard.of(mesh, num_frames)
    with torch.inference_mode():
        px = vae.decode(shard_frames(torch.tensor(z), mesh), shard.local, shard)
    return gather_frames(px, mesh)


def _tiny_pipe(mesh, backbone: str, states, num_frames: int):
    if backbone == "sd":
        from univst_torch.pipelines.sd import SDVideoPipeline

        pipe = SDVideoPipeline.build(variant="tiny", num_frames=num_frames, dtype=torch.float32,
                                     capture_up_block=2, device="cpu")
    else:
        from univst_torch.pipelines.animatediff import build_animatediff

        pipe = build_animatediff(variant="tiny", num_frames=num_frames, dtype=torch.float32,
                                 capture_up_block=2, device="cpu")
    if states is not None and (mesh is None or mesh.rank == 0):
        for module, sd in zip((pipe.unet, pipe.vae, pipe.text_encoder), states):
            module.load_state_dict(sd, strict=True)
    # rank 0 alone holds the weights: with_mesh must replicate them
    return pipe.with_mesh(mesh)


def sd_pipeline(mesh, backbone: str, states, num_frames: int, steps: int, inputs: dict,
                shift: dict, singleton: bool = True):
    """The tiny pipeline's ``stylize_latents`` and ``invert`` (feature
    captured), under ``mesh``."""
    from univst_torch.core.config import StyleShiftConfig, StyleTransferConfig

    pipe = dataclasses.replace(_tiny_pipe(mesh, backbone, states, num_frames),
                               style_singleton=singleton)
    ctx = pipe.encode_text("")
    out = pipe.stylize_latents(
        torch.tensor(inputs["content"]), torch.tensor(inputs["style"]),
        torch.tensor(inputs["init"]), torch.cat([ctx] * 3), mask=torch.tensor(inputs["mask"]),
        cfg=StyleTransferConfig(num_steps=steps), style_cfg=StyleShiftConfig(**shift))
    traj, feat = pipe.invert(torch.tensor(inputs["init"]), ctx, num_steps=steps,
                             is_opt=inputs.get("is_opt", True),
                             capture_timestep=inputs.get("capture_timestep"))
    return out, traj, feat


def unet_census(mesh, backbone: str, num_frames: int, x, t: int, mode: str):
    """One UNet forward of the tiny pipeline (seeded random weights) under
    ``mesh``. ``mode`` 'invert': the one-branch forward of the inversion,
    ``x`` [F, h, w, 4]; 'inject': the injected 2-branch stylization forward,
    ``x`` [2F, h, w, 4] ([content | stylized]), the style K/V from a
    single-frame pre-pass of ``x[:1]``.

    Returns the gathered eps, the collective census of the forward, the
    collectives a ``torch.profiler`` trace of it saw, the input shapes of
    its sparse-causal attentions (``[B*f, L, D]``) and the number of its
    frame-spanning GroupNorm calls."""
    from torch.profiler import ProfilerActivity, profile

    from univst_torch.distributed.census import collect_collectives, profiler_collectives
    from univst_torch.distributed.mesh import gather_frames
    from univst_torch.models.layers import GroupNorm, SelfAttention

    pipe = _tiny_pipe(mesh, backbone, None, num_frames)
    ctx = pipe.encode_text("")
    xt, f = torch.tensor(x), num_frames
    attn, norms = [], []
    for m in pipe.unet.modules():
        if isinstance(m, SelfAttention):
            m.register_forward_hook(lambda mod, args, out: attn.append(tuple(args[0].shape)))
        if isinstance(m, GroupNorm) and m.across_frames:
            m.register_forward_hook(lambda mod, args, out: norms.append(1))
    with torch.inference_mode():
        if mode == "invert":
            denoise = pipe._denoise_fn(ctx, pipe.base_frame_indices, None)
            xs, kw = pipe._shard(xt), {}
        else:
            ctx3 = torch.cat([ctx] * 3)
            kv = pipe._style_prepass(xt[None, :1], np.asarray([t]), ctx3, 1)
            denoise = pipe._denoise_fn(torch.cat([ctx, ctx]), pipe.pnp_frame_indices,
                                       pipe.style_shift_cfg)
            xs = torch.cat([pipe._shard(xt[:f]), pipe._shard(xt[f:])])
            kw = dict(style_kv=tuple((k[0][None], v[0][None]) for k, v in kv))
        attn.clear()
        norms.clear()
        with collect_collectives() as recs, profile(activities=[ProfilerActivity.CPU]) as prof:
            eps, _ = denoise(xs, t, 0, **kw)
        b = eps.shape[0] // (f // mesh.n_data)
        eps = gather_frames(eps.reshape((b, -1) + eps.shape[1:]), mesh, axis=1)
    return eps.reshape((-1,) + eps.shape[2:]), recs, profiler_collectives(prof), attn, len(norms)


def workflow(mesh, argv):
    """``univst_torch.cli.run_workflow`` under ``mesh`` (``--mesh`` in
    ``argv``; the group exists already)."""
    from univst_torch.cli import run_workflow

    run_workflow.main(run_workflow.build_parser().parse_args(argv))
    return mesh.rank


def noise(seed: int, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def mmdit_forward(mesh, state, cfg_kw: dict, x, ctx, pooled, t: float, shift_step=None):
    """The tiny MMDiT (``MMDiTConfig.tiny(**cfg_kw)``, rank 0's weights
    ``state``, replicated, then split over the tensor axis) on this data
    rank's frames of each video of ``x`` [B, F, h, w, C] with
    ``SD3_FRAME_INDICES`` (``shift_step``: the 3-branch stylization forward
    at that step, ``SD3_STYLE_SHIFT``'s AdaIN shift on): the gathered
    velocity, the collective census, the collectives a ``torch.profiler``
    trace saw, by op, the head counts the q/k RMS norms saw and those the
    AdaIN shift saw, call by call."""
    from torch.profiler import ProfilerActivity, profile

    from univst_torch.attention import ops
    from univst_torch.core.config import SD3_FRAME_INDICES, SD3_STYLE_SHIFT
    from univst_torch.distributed.census import collect_collectives, profiler_ops
    from univst_torch.distributed.comm import FrameShard
    from univst_torch.distributed.mesh import gather_frames, replicate, shard_frames
    from univst_torch.distributed.tp import shard_mmdit
    from univst_torch.models.layers import StyleCtx, VideoCtx
    from univst_torch.models.mmdit import MMDiT, MMDiTConfig, RMSNorm

    model = MMDiT(MMDiTConfig.tiny(**cfg_kw)).eval()
    if mesh.rank == 0:
        model.load_state_dict(state, strict=True)
    shard_mmdit(replicate(model, mesh), mesh)
    b, f = x.shape[:2]
    shard = FrameShard.of(mesh, f) if mesh.n_data > 1 else None
    vctx = VideoCtx(num_frames=f if shard is None else shard.local,
                    frame_indices=SD3_FRAME_INDICES, shard=shard)
    sctx = None if shift_step is None else StyleCtx(step_idx=shift_step, cfg=SD3_STYLE_SHIFT)
    heads = []
    for m in model.modules():
        if isinstance(m, RMSNorm):
            m.register_forward_hook(lambda mod, args, out: heads.append(args[0].shape[-2]))
    adain, adain_heads = ops.attention_adain_sd3_tm, []

    def counted_adain(cnt, sty):
        adain_heads.append(cnt.shape[-2])
        return adain(cnt, sty)

    ops.attention_adain_sd3_tm = counted_adain
    xs = shard_frames(torch.tensor(x), mesh, axis=1)
    try:
        with torch.inference_mode(), collect_collectives() as recs, \
                profile(activities=[ProfilerActivity.CPU]) as prof:
            v, _ = model(xs.reshape((-1,) + xs.shape[2:]), t,
                         torch.tensor(ctx).expand(b, -1, -1),
                         torch.tensor(pooled).expand(b, -1), vctx, sctx)
    finally:
        ops.attention_adain_sd3_tm = adain
    v = gather_frames(v.reshape(xs.shape), mesh, axis=1)
    return v, recs, profiler_ops(prof), sorted(set(heads)), adain_heads


def sd3_pipeline(mesh, states, num_frames: int, steps: int, inputs: dict, shift: dict):
    """The tiny SD3 pipeline (rank 0's weights ``states`` for the MMDiT, VAE,
    CLIP-L, CLIP-G and T5) under ``mesh``: ``stylize_latents`` (singleton,
    both phases, mask) and ``invert`` (RF-Inversion) on the prompt ''."""
    from univst_torch.core.config import StyleShiftConfig, StyleTransferConfig
    from univst_torch.pipelines.sd3 import SD3VideoPipeline

    pipe = SD3VideoPipeline.build(variant="tiny", num_frames=num_frames, dtype=torch.float32,
                                  device="cpu")
    if states is not None and (mesh is None or mesh.rank == 0):
        for module, sd in zip((pipe.mmdit, pipe.vae, pipe.clip_l, pipe.clip_g, pipe.t5),
                              states):
            module.load_state_dict(sd, strict=True)
    pipe = pipe.with_mesh(mesh)
    ctx, pooled = pipe.encode_prompt("")
    out = pipe.stylize_latents(
        torch.tensor(inputs["content"]), torch.tensor(inputs["style"]),
        torch.tensor(inputs["init"]), torch.tensor(inputs["img"]), torch.cat([ctx] * 3),
        torch.cat([pooled] * 3), mask=torch.tensor(inputs["mask"]),
        cfg=StyleTransferConfig(num_steps=steps), style_cfg=StyleShiftConfig(**shift))
    traj, _ = pipe.invert(torch.tensor(inputs["init"]), ctx, pooled, num_steps=steps)
    return out, traj


def pair_flow(a, b):
    """A flow function both frameworks compute alike (elementwise in the
    images; ``test_torch_flow.py``'s), for testing what surrounds the
    estimator."""
    return torch.stack([4.0 * (a[..., 0] - b[..., 1]), 3.0 * (a[..., 2] - b[..., 0])], -1)


def _counted(fn, batches: list):
    """``fn`` that appends the batch size of every call to ``batches``."""
    def counted(a, b):
        batches.append(int(a.shape[0]))
        return fn(a, b)
    return counted


def window_smooth(mesh, frames, mask, cases):
    """``sliding_window_smooth``'s shard form on this rank's frames of
    ``frames`` [F, H, W, C] for each case ``(radius, flow, masked)`` (flow
    'pair' or 'lk'): the gathered result, the collective census of the
    call and the batch sizes its flow function saw."""
    from univst_torch.distributed.census import collect_collectives
    from univst_torch.distributed.comm import FrameShard
    from univst_torch.distributed.mesh import gather_frames, shard_frames
    from univst_torch.methods import flow

    shard = FrameShard.of(mesh, frames.shape[0])
    local = shard_frames(torch.tensor(frames), mesh)
    lmask = shard_frames(torch.tensor(mask), mesh)
    out = []
    for radius, flow_name, masked in cases:
        batches: list = []
        fn = _counted(pair_flow if flow_name == "pair" else flow.lucas_kanade_flow, batches)
        with collect_collectives() as recs:
            got = flow.sliding_window_smooth(local, fn, radius, lmask if masked else None,
                                             shard=shard)
        out.append((gather_frames(got, mesh), recs, batches))
    return out


def smoothed_stylization(mesh, backbone: str, states, num_frames: int, inputs: dict,
                         shift: dict, cfg: dict, paths):
    """The tiny pipeline's ``stylize_latents`` with the pixel smoother
    (``StyleTransferConfig(**cfg)``) under ``mesh``, once per entry of
    ``paths`` (pipeline fields: ``style_singleton``, ``style_prepass_chunk``):
    per path the gathered latents, the collective census of each smoothing
    step and the batch sizes the flow function saw."""
    from univst_torch.core.config import StyleShiftConfig, StyleTransferConfig
    from univst_torch.distributed.census import collect_collectives
    from univst_torch.methods import flow

    base = _tiny_pipe(mesh, backbone, states, num_frames)
    ctx = base.encode_text("")
    res = []
    for path in paths:
        batches: list = []
        recs: list = []
        pipe = dataclasses.replace(base, flow_fn=_counted(flow.lucas_kanade_flow, batches),
                                   **path)
        smooth_eps = pipe._smooth_eps

        def censused(*a, smooth_eps=smooth_eps, recs=recs, **kw):
            with collect_collectives() as step:
                out = smooth_eps(*a, **kw)
            recs.append(step)
            return out

        pipe._smooth_eps = censused
        out = pipe.stylize_latents(
            torch.tensor(inputs["content"]), torch.tensor(inputs["style"]),
            torch.tensor(inputs["init"]), torch.cat([ctx] * 3),
            mask=torch.tensor(inputs["mask"]), cfg=StyleTransferConfig(**cfg),
            style_cfg=StyleShiftConfig(**shift))
        res.append((out, recs, batches))
    return res
