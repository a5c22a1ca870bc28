"""SD-1.5 / SD-2.1 video pipeline — port of ``univst_tpu/pipelines/sd.py``
(rebuild of SpatioTemporalStableDiffusionPipeline,
backbones/video_diffusion_sd/pipelines/stable_diffusion.py:45-876).

The pipeline owns the modules and runs each stage as one Python loop over
the method functions in ``univst_torch.methods``. Weights come from a
diffusers-layout checkpoint directory (strict load), or from a seeded random
init with the same architecture (throughput runs and tests).

Tensors keep the JAX package's layouts: frames ``[F, H, W, 3]``, latents
``[F, h, w, 4]``, trajectories ``[N+1, F, h, w, 4]``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, List, Optional

import numpy as np
import torch
from torch import nn

from univst_torch.core.config import (
    SD_BASE_FRAME_INDICES,
    SD_PNP_FRAME_INDICES,
    SD_STYLE_SHIFT,
    StyleShiftConfig,
    StyleTransferConfig,
)
from univst_torch.core.scheduler import DDIMConfig, DDIMSchedule, EasyInvConfig
from univst_torch.distributed.comm import FrameShard
from univst_torch.distributed.mesh import (
    Mesh, gather_frames, replicate, replicate_input, shard_input,
)
from univst_torch.methods import flow
from univst_torch.methods import inversion as inv
from univst_torch.methods.style_transfer import style_transfer_ddim_steps
from univst_torch.models.clip_text import CLIPTextConfig, CLIPTextModel, Tokenizer
from univst_torch.models.convert import load_pretrained
from univst_torch.models.layers import StyleCtx, VideoCtx
from univst_torch.models.unet_sd import UNetPseudo3D, UNetSDConfig, extract_pnp_kv
from univst_torch.models.vae import AutoencoderKL, VAEConfig, sample_latent
from univst_torch.pipelines.segments import phase_segments
from univst_torch.utils.profiling import NO_SPAN, SPANS


def resolve_device(device=None) -> torch.device:
    """The device to run on: CUDA unless the caller asks for the CPU. With
    no GPU and no explicit request this raises rather than fall back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' (or --platform cpu) "
                               "to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def set_precision() -> None:
    """Full-precision fp32 matmuls and convolutions (no TF32) wherever the
    working type is fp32; bf16 is the default working type on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights in the JAX package's init families: lecun-normal
    matrices and kernels, zero biases, unit norm scales, 0.5 blend factors."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "mix_factor":
            p.fill_(0.5)
        elif p.dim() >= 2:
            fan_in = p[0].numel() if not name.endswith("embedding.weight") else p.shape[1]
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device)
                    / math.sqrt(fan_in))
        elif leaf == "weight":
            p.fill_(1.0)
        else:
            p.zero_()


class FrameParallel:
    """The frame-axis plumbing a pipeline runs under a mesh (``with_mesh``);
    the pipeline has ``mesh``, ``gather``, ``num_frames`` and ``device``.
    Serves the SD / AnimateDiff and the SD3 pipelines."""

    def _frame_shard(self, num_frames: Optional[int] = None) -> Optional[FrameShard]:
        """This rank's share of a ``num_frames`` clip (default the
        pipeline's), or None: no data axis, or a count it does not divide."""
        nf = self.num_frames if num_frames is None else num_frames
        if self.mesh is None or self.mesh.n_data == 1 or nf % self.mesh.n_data:
            return None
        return FrameShard.of(self.mesh, nf)

    def _shard(self, x, axis: int = 0, num_frames: Optional[int] = None):
        """The rank's slice of a whole-clip input's frame axis; an input that
        is already a shard, or whose axis is not the clip's (a single style
        frame), passes."""
        nf = self.num_frames if num_frames is None else num_frames
        if x is None or self._frame_shard(nf) is None or x.shape[axis] != nf:
            return x
        return shard_input(self.mesh, torch.as_tensor(x), axis)

    def _replicated(self, x):
        """Rank 0's ``x`` on every rank, on the pipeline's device."""
        return replicate_input(self.mesh, None if x is None else x.to(self.device))

    def _gather(self, x, shard: Optional[FrameShard], axis: int = 0):
        if shard is None or not self.gather or x is None:
            return x
        return gather_frames(x, self.mesh, axis, site="outputs")


@dataclasses.dataclass
class SDVideoPipeline(FrameParallel):
    """Also serves AnimateDiff (``pipelines/animatediff.py::build_animatediff``):
    the two epsilon backbones share every stage; the denoiser module, the
    DDIM beta schedule, the shift constants and the frame-index sets
    differ."""

    unet: nn.Module  # UNetPseudo3D | UNetAnimateDiff (same call signature)
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    tokenizer: Tokenizer
    schedule: DDIMSchedule
    num_frames: int
    device: torch.device
    dtype: torch.dtype = torch.bfloat16
    style_shift_cfg: StyleShiftConfig = SD_STYLE_SHIFT
    base_frame_indices: tuple = SD_BASE_FRAME_INDICES
    pnp_frame_indices: tuple = SD_PNP_FRAME_INDICES
    # Run the style branch as a single frame with its PnP K/V computed for
    # all steps in one batched pre-pass: exact when the style trajectory's
    # frames are identical (a repeated style image). False for AnimateDiff,
    # whose motion modules give each frame its own position, and for a
    # style trajectory whose frames differ.
    style_singleton: bool = True
    # Off the singleton path, capture the style branch's K/V for this many
    # steps in one [chunk*F]-row forward (steps batch as extra videos: the
    # frame positions vary per frame, not per step). None: one F-row capture
    # forward per step.
    style_prepass_chunk: Optional[int] = None
    # The pixel smoother's optical flow, a batched ``flow_fn(img1, img2)``
    # of ``methods/flow.py``: None is the built-in Lucas-Kanade pyramid;
    # ``models.raft.make_raft_flow`` gives RAFT (the reference smoother's
    # flow, src/cal_optica_flow.py:53-54).
    flow_fn: Optional[Callable] = None
    # Frame parallelism (``with_mesh``): every rank holds the modules and
    # the whole input, and runs its share of the frames.
    mesh: Optional[Mesh] = None
    # Under a mesh, gather each stage's frame-axis outputs onto every rank
    # (True), or return the rank's shard (False; a later stage takes either).
    gather: bool = True

    # -- construction --------------------------------------------------------

    @classmethod
    def build(
        cls,
        pretrained_model_path: Optional[str] = None,
        variant: str = "sd15",
        num_frames: int = 16,
        dtype: torch.dtype = torch.bfloat16,
        capture_up_block: Optional[int] = None,
        seed: int = 0,
        device=None,
        mesh: Optional[Mesh] = None,
        unet_cfg: Optional[UNetSDConfig] = None,
        clip_cfg: Optional[CLIPTextConfig] = None,
    ) -> "SDVideoPipeline":
        """Build the modules on ``device`` (CUDA unless the CPU is asked for)
        and load a checkpoint directory strictly when one is given; else
        random weights from a generator seeded with ``seed``. The UNet is
        paired with the SVD temporal-decoder VAE, as the reference does
        (run_content_inversion_sd.py:41-43). The modules take any size.
        ``mesh``: frame-parallel over it (:meth:`with_mesh`). ``unet_cfg``
        and ``clip_cfg`` replace the variant's configs, as in
        univst_tpu/pipelines/sd.py:117-134 (``capture_up_block`` still
        applies to a given ``unet_cfg``)."""
        device = resolve_device(device)
        set_precision()
        if unet_cfg is None:
            unet_cfg = {"sd15": UNetSDConfig.sd15, "sd21": UNetSDConfig.sd21,
                        "tiny": UNetSDConfig.tiny}[variant](capture_up_block=capture_up_block)
        elif capture_up_block is not None:
            unet_cfg = dataclasses.replace(unet_cfg, capture_up_block=capture_up_block)
        vae_cfg = (VAEConfig.svd() if variant in ("sd15", "sd21")
                   else VAEConfig.tiny(temporal_decoder=True))
        if clip_cfg is None:
            clip_cfg = {"sd15": CLIPTextConfig.sd15, "sd21": CLIPTextConfig.sd21,
                        "tiny": CLIPTextConfig.tiny}[variant]()

        with torch.device(device):
            unet, vae, text = UNetPseudo3D(unet_cfg), AutoencoderKL(vae_cfg), CLIPTextModel(clip_cfg)
        if pretrained_model_path:
            load_pretrained(pretrained_model_path, unet, vae, text)
        else:
            gen = torch.Generator(device=device).manual_seed(seed)
            for m in (unet, vae, text):
                random_init_(m, gen)
        for m in (unet, vae, text):
            m.to(dtype).eval().requires_grad_(False)

        tok_dir = None
        if pretrained_model_path:
            cand = os.path.join(pretrained_model_path, "tokenizer")
            tok_dir = cand if os.path.isdir(cand) else None
        return cls(unet=unet, vae=vae, text_encoder=text, tokenizer=Tokenizer(tok_dir),
                   schedule=DDIMSchedule(DDIMConfig()), num_frames=num_frames,
                   device=device, dtype=dtype).with_mesh(mesh)

    def with_frames(self, num_frames: int) -> "SDVideoPipeline":
        """The same modules driven at another frame count (the single-frame
        style inversion shares the content pipeline's weights)."""
        return dataclasses.replace(self, num_frames=num_frames)

    # -- frame parallelism -------------------------------------------------------

    def with_mesh(self, mesh: Optional[Mesh], gather: bool = True) -> "SDVideoPipeline":
        """The pipeline running frame-parallel over ``mesh`` (the counterpart
        of univst_tpu/pipelines/sd.py:197-226): the modules are replicated
        from rank 0; every stage then takes the whole input on every rank,
        runs the rank's share of the frames (``_shard``; a frame count that
        does not divide the mesh, such as the single-frame style inversion,
        runs replicated) with the collectives of ``distributed.comm``, and
        gathers its frame-axis outputs (``gather=False``: returns the
        rank's shard). Serves SD and AnimateDiff alike. On a mesh with a
        tensor axis the modules are replicated over it too, as the JAX
        package's are: the ``n_tensor`` ranks of a data shard run its frames
        alike, and the frame collectives run over each data group."""
        if mesh is None:
            return self
        for m in (self.unet, self.vae, self.text_encoder):
            replicate(m, mesh)
        return dataclasses.replace(self, mesh=mesh, gather=gather)

    def _video_ctx(self, num_frames: int, frame_indices, pnp_frame_indices=None) -> VideoCtx:
        """The video context of a ``num_frames`` forward: the rank's share
        and its ``shard`` under a mesh."""
        shard = self._frame_shard(num_frames)
        return VideoCtx(num_frames=num_frames if shard is None else shard.local,
                        frame_indices=tuple(frame_indices),
                        pnp_frame_indices=None if pnp_frame_indices is None
                        else tuple(pnp_frame_indices), shard=shard)

    # -- stages ---------------------------------------------------------------

    @torch.inference_mode()
    def encode_text(self, prompt: str):
        ids = torch.as_tensor(self.tokenizer(prompt), dtype=torch.long, device=self.device)
        return self.text_encoder(ids)[0]  # [1, 77, D]

    @torch.inference_mode()
    def encode_frames(self, frames, generator: Optional[torch.Generator] = None, noise=None):
        """[F, H, W, 3] in [-1, 1] -> sampled latents [F, h, w, 4] * scaling
        (fp32). ``noise`` overrides the posterior draw from ``generator``.
        Under a mesh each rank encodes its frames and takes its slice of the
        whole clip's draw."""
        x = torch.as_tensor(np.asarray(frames), device=self.device)
        nf, shard = x.shape[0], self._frame_shard(x.shape[0])
        mean, logvar = self.vae.encode(self._shard(x, num_frames=nf).to(self.dtype))
        if shard is not None:
            if noise is None:
                noise = torch.randn((nf,) + tuple(mean.shape[1:]), generator=generator,
                                    device=mean.device, dtype=torch.float32)
            noise = self._shard(torch.as_tensor(noise), num_frames=nf)
        z = sample_latent(mean.float(), logvar.float(), generator, noise)
        return self._gather(z * self.vae.cfg.scaling_factor, shard)

    @torch.inference_mode()
    def _decode(self, latents, num_frames: int):
        shard = self._frame_shard(num_frames)
        px = self._decode_local(self._shard(latents, num_frames=num_frames), shard)
        return self._gather(px, shard)

    def _decode_local(self, latents, shard: Optional[FrameShard]):
        """The rank's latents ``[f, h, w, 4]`` -> its frames ``[f, H, W, 3]`` in
        [0, 1]: the temporal decoder reads the neighbour ranks' frames
        through its halos (``models/vae.py::_time_conv``); no shard: the
        whole clip."""
        z = (latents.to(self.device).float() / self.vae.cfg.scaling_factor).to(self.dtype)
        px = self.vae.decode(z, latents.shape[0], shard)
        return torch.clamp(px.float() / 2.0 + 0.5, 0.0, 1.0)

    def decode_latents(self, latents):
        """latents [F, h, w, 4] -> frames [F, H, W, 3] in [0, 1] (reference
        decode_latents, stable_diffusion.py:369-394)."""
        return self._decode(latents, self.num_frames)

    def decode_latents_uint8(self, latents):
        return torch.round(self.decode_latents(latents) * 255.0).to(torch.uint8)

    def decode_latents_uint8_chunks(self, latents, chunk: int) -> List[torch.Tensor]:
        """Chunked temporal-VAE decode (the reference's ``decode_chunk_size``,
        stable_diffusion.py:369-385): each chunk's temporal decoder sees its
        own frame count. Returns one uint8 tensor per chunk."""
        n = latents.shape[0]
        if chunk < n and n % chunk:
            raise ValueError(f"chunk {chunk} must divide the frame count {n}")
        with SPANS.span("decode", device=self.device) if SPANS.on else NO_SPAN:
            if chunk >= n:
                return [self.decode_latents_uint8(latents)]
            return [torch.round(self._decode(latents[s:s + chunk], chunk) * 255.0)
                    .to(torch.uint8) for s in range(0, n, chunk)]

    # -- denoiser closures ----------------------------------------------------

    def _denoise_fn(self, context, frame_indices, style_cfg: Optional[StyleShiftConfig],
                    pnp_plain: bool = False, num_frames: Optional[int] = None):
        """``pnp_plain=True`` is the stylized-only denoiser past the shift
        window: the 8 patched layers keep their PnP index set (the window only
        gates the AdaIN shift, pnp_utils.py:25,47) but nothing is shifted."""
        f = self.num_frames if num_frames is None else num_frames
        if style_cfg is None and not pnp_plain:
            # inversion / reconstruction: unpatched model, default indices
            vctx = self._video_ctx(f, frame_indices)
        else:
            vctx = self._video_ctx(f, self.base_frame_indices, frame_indices)

        def denoise(latents, t, step_idx, style_kv=None):
            if style_cfg is not None:
                sctx = StyleCtx(step_idx=step_idx, cfg=style_cfg, style_kv=style_kv)
            elif pnp_plain:
                sctx = StyleCtx(step_idx=step_idx)
            else:
                sctx = None
            eps, feat = self.unet(latents.to(self.dtype), t, context, vctx, sctx)
            return eps.float(), feat

        return denoise

    # -- workflows --------------------------------------------------------------

    @torch.inference_mode()
    def invert(self, latents, context, num_steps: int = 50, is_opt: bool = True,
               capture_timestep: Optional[int] = None):
        """Content/style inversion -> (trajectory [N+1, ...], captured feature)
        (reference ddim_inversion, inversion_tools/ddim_inversion.py:71-84)."""
        ts = self.schedule.timesteps(num_steps)[::-1]
        shard = self._frame_shard()
        latents = self._shard(latents).to(self.device).float()
        context = self._replicated(context)
        denoise = self._denoise_fn(context, self.base_frame_indices, None)
        if self.unet.cfg.capture_up_block is None:
            capture_timestep = None
        (_, _, captured), traj = inv.ddim_invert_segment(
            denoise, (latents, latents, None), range(num_steps), ts, self.schedule,
            num_steps, easyinv=EasyInvConfig() if is_opt else None,
            capture_timestep=capture_timestep)
        return (self._gather(torch.cat([latents[None], traj]), shard, axis=1),
                self._gather(captured, shard))

    @torch.inference_mode()
    def reconstruct_latents(self, latents_T, context, num_steps: int = 50,
                            guidance_scale: float = 1.0, uncond_context=None):
        """xT -> x0 reconstruction with classifier-free guidance. The
        reference runs the [uncond | cond] batch (stable_diffusion.py:560-614)
        and its callers pass guidance 1.0 (ddim_inversion.py:40,63), where
        guidance is the identity: at 1 one batch runs here. Above 1 the
        [uncond | cond] batch runs and the eps are combined
        (stable_diffusion.py:588-614); ``uncond_context`` defaults to the
        empty prompt's embedding."""
        ts = self.schedule.timesteps(num_steps)
        shard = self._frame_shard()
        latent = self._shard(latents_T).to(self.device).float()
        context = self._replicated(context)
        if guidance_scale > 1.0:
            uc = uncond_context if uncond_context is not None else self.encode_text("")
            denoise2 = self._denoise_fn(torch.cat([uc.to(self.device), context]),
                                        self.base_frame_indices, None)

            def denoise(lat, t, i):
                eps_u, eps_c = denoise2(torch.cat([lat, lat]), t, i)[0].chunk(2)
                return eps_u + guidance_scale * (eps_c - eps_u), None
        else:
            denoise = self._denoise_fn(context, self.base_frame_indices, None)
        return self._gather(inv.ddim_sample_segment(denoise, latent, range(num_steps), ts,
                                                    self.schedule, num_steps), shard)

    @torch.inference_mode()
    def stylize_latents(self, content_traj_rev, style_traj_rev, init_latents, context3,
                        mask=None, cfg: StyleTransferConfig = StyleTransferConfig(),
                        style_cfg: Optional[StyleShiftConfig] = None):
        """Stylization (reference video_style_transfer,
        stable_diffusion.py:630-766): a multi-branch phase 1 inside the shift
        window, then phase 2 — past it, where the content and style branches
        are dead compute — the stylized branch alone.

        Phase 1 on the style-singleton path (``style_singleton``): the style
        branch runs once as a single frame; a batched pre-pass computes its
        PnP K/V for every phase-1 step and the 2-branch [content | stylized]
        batch gets that K/V injected. Otherwise capture-and-inject: per step
        an F-row style forward captures the K/V (or one forward per
        ``style_prepass_chunk`` steps), then the injected 2-branch batch.

        With ``cfg.smoother == 'pixel'`` phase 1 reaches at least to the end
        of the smoothing steps, and each step in ``cfg.smoother_steps`` =
        [lo, hi) smooths its x0 estimate in pixel space (:meth:`_smooth_eps`)
        on whichever phase-1 path runs.

        Under a mesh the trajectories (frame axis 1), the initial latents and
        the mask (axis 0) are sharded, the text context replicated; the
        singleton style pre-pass runs replicated on every rank. A smoothing
        step runs frame-parallel too: each rank decodes its own frames,
        fetches the +/-radius decoded frames its keys read from the other
        ranks in one all-to-all, runs the flows of its own keys' pairs and
        encodes its own smoothed frames.
        """
        scfg = style_cfg if style_cfg is not None else self.style_shift_cfg
        n = cfg.num_steps
        ts = self.schedule.timesteps(n)
        dev = self.device
        shard = self._frame_shard()
        content_traj_rev = self._shard(content_traj_rev, axis=1).to(dev)
        style_traj_rev = self._shard(style_traj_rev, axis=1).to(dev)
        init_latents = self._shard(init_latents)
        mask = None if mask is None else self._shard(torch.as_tensor(mask, device=dev))
        context3 = self._replicated(context3.to(dev))
        if cfg.smoother not in (None, "pixel"):
            raise ValueError(f"smoother {cfg.smoother!r}: use None or 'pixel'")

        window_end = scfg.window_end()
        if cfg.smoother is not None:
            # the smoothing steps take the full multi-branch step: keep them in phase 1
            window_end = max(window_end, cfg.smoother_steps[1])
        phase1, phase2 = phase_segments(n, window_end)
        k1 = phase2[0][0] if phase2 else n
        latents = init_latents.to(dev).float()
        hook = self._smooth_hook(cfg, mask)
        with SPANS.span("stylize", device=dev) if SPANS.on else NO_SPAN:
            if self.style_singleton:
                style_traj_rev = style_traj_rev[:, :1]
                if phase1:
                    with SPANS.span("prepass") if SPANS.on else NO_SPAN:
                        style_kv_all = self._style_prepass(style_traj_rev, ts[:k1], context3, k1)
                for s0, c in phase1:
                    with SPANS.span("phase1", start=s0, steps=c) if SPANS.on else NO_SPAN:
                        latents = self._stylize_chunk_singleton(
                            content_traj_rev, style_traj_rev, style_kv_all, latents, ts, s0,
                            context3, mask, cfg, scfg, c, hook)
            else:
                # the full per-frame style latents: the AdaIN re-anchor's
                # statistics span frames (latent_adain dims [0, 3, 4])
                if style_traj_rev.shape[1] == 1 and self.num_frames > 1:
                    style_traj_rev = style_traj_rev.expand(-1, content_traj_rev.shape[1], -1, -1,
                                                           -1)
                pc = self.style_prepass_chunk
                for s0, c in phase1:
                    with SPANS.span("phase1", start=s0, steps=c) if SPANS.on else NO_SPAN:
                        if pc:
                            for t0 in range(s0, s0 + c, pc):
                                latents = self._stylize_chunk_prepass(
                                    content_traj_rev, style_traj_rev, latents, ts, t0, context3,
                                    mask, cfg, scfg, min(pc, s0 + c - t0), hook)
                        else:
                            latents = self._stylize_chunk_capture(
                                content_traj_rev, style_traj_rev, latents, ts, s0, context3,
                                mask, cfg, scfg, c, hook)
            for s0, c in phase2:
                with SPANS.span("phase2", start=s0, steps=c) if SPANS.on else NO_SPAN:
                    latents = self._stylize_chunk_solo(content_traj_rev, style_traj_rev, latents,
                                                       ts, s0, context3, mask, cfg, c)
            return self._gather(latents, shard)

    def _style_prepass(self, style_traj_rev, ts, context3, k1: int):
        """The style branch's projected PnP K/V for all k1 steps in one
        batched single-frame call: a tuple over PNP_SLOT_ORDER of (k, v),
        each ``[k1, L, D]``."""
        sctx = StyleCtx(step_idx=0, cfg=self.style_shift_cfg, capture=True)
        ctx = context3[1:2].expand(k1, -1, -1)
        self.unet(style_traj_rev[:k1, 0].to(self.dtype),
                  torch.as_tensor(np.ascontiguousarray(ts), device=self.device), ctx,
                  VideoCtx(num_frames=1, frame_indices=()), sctx)
        return extract_pnp_kv(sctx.captured)

    def _stylize_chunk_singleton(self, content, style, style_kv_all, latents, ts, s0,
                                 context3, mask, cfg, style_cfg, chunk, eps_hook=None):
        """Phase-1 segment: the 2-branch [content | stylized] batch."""
        denoise = self._denoise_fn(torch.cat([context3[:1], context3[2:3]]),
                                   self.pnp_frame_indices, style_cfg)

        def denoise2(x2, t, i, kv):
            # the step's single-frame K/V, injected as [1, L, D]
            return denoise(x2, t, i, style_kv=tuple((k[None], v[None]) for k, v in kv))[0]

        sl = slice(s0, s0 + chunk)
        return style_transfer_ddim_steps(
            denoise2, content[sl], style[sl], latents, range(s0, s0 + chunk), ts[sl],
            self.schedule, cfg, mask=mask, eps_hook=eps_hook,
            style_kv=tuple((k[sl], v[sl]) for k, v in style_kv_all), shard=self._frame_shard())

    def _stylize_vctx(self, num_frames: int) -> VideoCtx:
        """The stylization forward's video context: the patched decoder
        layers use the PnP index set, the rest the model default."""
        return self._video_ctx(num_frames, self.base_frame_indices, self.pnp_frame_indices)

    def _stylize_chunk_capture(self, content, style, latents, ts, s0, context3, mask, cfg,
                               style_cfg, chunk, eps_hook=None):
        """Phase-1 segment, capture-and-inject: per step, the style branch
        alone (F rows) records its PnP K/V, then the 2-branch [content |
        stylized] batch runs with that ``[F, L, D]`` K/V injected. Exact
        against the 3-branch batch: the branches couple only through the
        attention shift, which reads the style branch's raw projected K/V
        (pnp_utils.py:47-57); unlike the singleton pre-pass it needs no
        identical style frames."""
        denoise = self._denoise_fn(torch.cat([context3[:1], context3[2:3]]),
                                   self.pnp_frame_indices, style_cfg)
        vctx, ctx_sty = self._stylize_vctx(self.num_frames), context3[1:2]

        def denoise2(x2, t, i, sty_lat):
            sctx = StyleCtx(step_idx=i, cfg=style_cfg, capture=True)
            self.unet(sty_lat.to(self.dtype), t, ctx_sty, vctx, sctx)
            return denoise(x2, t, i, style_kv=extract_pnp_kv(sctx.captured))[0]

        sl = slice(s0, s0 + chunk)
        return style_transfer_ddim_steps(
            denoise2, content[sl], style[sl], latents, range(s0, s0 + chunk), ts[sl],
            self.schedule, cfg, mask=mask, capture=True, eps_hook=eps_hook,
            shard=self._frame_shard())

    def _stylize_chunk_prepass(self, content, style, latents, ts, s0, context3, mask, cfg,
                               style_cfg, chunk, eps_hook=None):
        """Batched form of :meth:`_stylize_chunk_capture`: the style branch's
        PnP K/V of all ``chunk`` steps from one ``[chunk*F]``-row forward,
        each step a video of its own with its own timestep (every op is per
        row or per F-row video, and the frame positions repeat per video),
        then the injected 2-branch steps."""
        vctx, sl = self._stylize_vctx(self.num_frames), slice(s0, s0 + chunk)
        f, style_seg = vctx.num_frames, style[sl]
        sctx = StyleCtx(step_idx=0, cfg=style_cfg, capture=True)
        self.unet(style_seg.reshape((chunk * f,) + style_seg.shape[2:]).to(self.dtype),
                  torch.as_tensor(np.ascontiguousarray(ts[sl]), device=self.device),
                  context3[1:2].expand(chunk * f, -1, -1), vctx, sctx)
        kv_all = tuple((k.reshape((chunk, f) + k.shape[1:]), v.reshape((chunk, f) + v.shape[1:]))
                       for k, v in extract_pnp_kv(sctx.captured))
        denoise = self._denoise_fn(torch.cat([context3[:1], context3[2:3]]),
                                   self.pnp_frame_indices, style_cfg)

        def denoise2(x2, t, i, kv_t):
            return denoise(x2, t, i, style_kv=kv_t)[0]

        return style_transfer_ddim_steps(
            denoise2, content[sl], style_seg, latents, range(s0, s0 + chunk), ts[sl],
            self.schedule, cfg, mask=mask, style_kv=kv_all, eps_hook=eps_hook,
            shard=vctx.shard)

    def _smooth_hook(self, cfg, mask) -> Optional[Callable]:
        """The pixel smoother as ``style_transfer_ddim_steps``' eps hook:
        the steps in ``cfg.smoother_steps`` get :meth:`_smooth_eps`; None
        without a smoother."""
        if cfg.smoother is None:
            return None
        lo, hi = cfg.smoother_steps

        def smooth(eps, t, i, latents):
            return self._smooth_eps(eps, t, latents, mask, cfg) if lo <= i < hi else eps

        return smooth

    def _smooth_eps(self, eps, t: int, latents, mask, cfg):
        """One smoothing step's eps (reference stable_diffusion.py:713-758;
        JAX ``_stylize_smooth_step``): estimate x0, decode it (the temporal
        decoder over all F frames), warp-average a +/-radius window of
        frames by optical flow (``methods/flow.py``) with the masked object
        region kept, re-encode (the posterior mean) and turn the smoothed
        x0 back into the eps that reaches it from x_t.

        Under a mesh ``eps``, ``latents`` and ``mask`` are the rank's frames,
        and so is the result: the rank decodes its frames (the decoder's
        temporal halos), smooths them (``sliding_window_smooth``'s shard
        form) and encodes them (the encoder is per frame); nothing is
        gathered."""
        shard = self._frame_shard()
        x0 = self.schedule.pred_original(eps, t, latents)
        px = self._decode_local(x0, shard)
        px = flow.sliding_window_smooth(px, self.flow_fn or flow.lucas_kanade_flow,
                                        radius=cfg.smoother_radius,
                                        mask=None if mask is None else mask.float(), shard=shard)
        mean, _ = self.vae.encode((px * 2.0 - 1.0).to(self.dtype))
        return self.schedule.return_to_timestep(t, latents,
                                                mean.float() * self.vae.cfg.scaling_factor)

    def _stylize_chunk_solo(self, content, style, latents, ts, s0, context3, mask, cfg, chunk):
        """Phase-2 segment: the stylized branch alone (the shift gate is off,
        so the patched attention uses its own q/k/v, and the reference keeps
        only the stylized epsilon, stable_diffusion.py:712)."""
        denoise = self._denoise_fn(context3[2:3], self.pnp_frame_indices, None, pnp_plain=True)

        def denoise1(x, t, i):
            return denoise(x, t, i)[0]

        sl = slice(s0, s0 + chunk)
        return style_transfer_ddim_steps(
            denoise1, content[sl], style[sl], latents, range(s0, s0 + chunk), ts[sl],
            self.schedule, cfg, mask=mask, solo=True, shard=self._frame_shard())
