"""SD3 / SD3.5 video pipeline — port of ``univst_tpu/pipelines/sd3.py``
(rebuild of CustomStableDiffusion3Pipeline,
backbones/video_diffusion_sd3/pipelines/custom_pipeline.py:17-445, plus the
runner's model build, src/sd3/run_content_inversion_sd3.py:42-68).

Text encoding follows diffusers' SD3 ``encode_prompt``: the penultimate
CLIP-L and CLIP-bigG hidden states concatenated on features and zero-padded
to the T5 width, then concatenated with the T5 sequence along tokens;
pooled = [pooled_l, pooled_g]. Frames are the batch axis (the SD3 reference
batches frames, flow_inversion.py:149-159). Latents and velocities stay
fp32 between steps; the modules run in the working type (bf16 on the card).

Weights come from a diffusers-layout checkpoint directory (strict loads) or
from a seeded random init. At full size every module is built on the
device, in the working type: T5-XXL alone holds 4.7B parameters.

Under a ``('data', 'tensor')`` mesh (:meth:`SD3VideoPipeline.with_mesh`)
the frame axis shards over ``data`` and the MMDiT's attention and MLP
linears split over ``tensor`` (``distributed/tp.py``), as the JAX
pipeline runs dp x tp (univst_tpu/pipelines/sd3.py:225-257).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from univst_torch.core.config import (
    SD3_FRAME_INDICES,
    SD3_STYLE_SHIFT,
    StyleShiftConfig,
    StyleTransferConfig,
)
from univst_torch.core.scheduler import (
    FlowMatchConfig,
    FlowMatchSchedule,
    calculate_shift,
    generate_eta_values,
    scale_eta_window,
)
from univst_torch.distributed.mesh import Mesh, replicate
from univst_torch.distributed.tp import shard_mmdit
from univst_torch.methods import inversion as inv
from univst_torch.methods.style_transfer import style_transfer_rf_steps
from univst_torch.models.clip_text import CLIPTextConfig, CLIPTextModel, Tokenizer
from univst_torch.models.convert import load_pretrained
from univst_torch.models.layers import StyleCtx, VideoCtx
from univst_torch.models.mmdit import MMDiT, MMDiTConfig, extract_mmdit_style_kv
from univst_torch.models.t5 import T5Config, T5Encoder, T5TokenizerShim
from univst_torch.models.vae import AutoencoderKL, VAEConfig, sample_latent
from univst_torch.pipelines.sd import (
    FrameParallel, random_init_, resolve_device, set_precision,
)
from univst_torch.pipelines.segments import phase_segments


@contextlib.contextmanager
def _default_dtype(dtype: torch.dtype):
    """Create parameters in ``dtype`` (no fp32 copy of a large model)."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def _configs(variant: str, capture_block: Optional[int]):
    """(MMDiT, VAE, CLIP-L, CLIP-G, T5 configs, T5 length, CLIP length)."""
    if variant in ("sd3", "sd35", "sd35m"):
        mcfg = {"sd3": MMDiTConfig.sd3_medium, "sd35": MMDiTConfig.sd35_large,
                # the reference CLIs' default checkpoint (SD3.5-medium, dual blocks)
                "sd35m": MMDiTConfig.sd35_medium}[variant](capture_block=capture_block)
        return (mcfg, VAEConfig.sd3(), CLIPTextConfig.sd3_clip_l(), CLIPTextConfig.sd3_clip_g(),
                T5Config.xxl(), 256, 77)
    if variant != "tiny":
        raise ValueError(f"unknown SD3 variant {variant!r}: sd3 | sd35 | sd35m | tiny")
    mcfg = MMDiTConfig.tiny(capture_block=capture_block)
    return (mcfg, VAEConfig.tiny(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609),
            CLIPTextConfig.tiny(projection_dim=16),
            CLIPTextConfig.tiny(projection_dim=mcfg.pooled_projection_dim - 16),
            T5Config.tiny(d_model=mcfg.joint_attention_dim), 16, 7)


@dataclasses.dataclass
class SD3VideoPipeline(FrameParallel):
    mmdit: MMDiT
    vae: AutoencoderKL
    clip_l: Optional[CLIPTextModel]
    clip_g: Optional[CLIPTextModel]
    t5: Optional[T5Encoder]
    tokenizer: Tokenizer
    tokenizer_3: T5TokenizerShim
    schedule: FlowMatchSchedule
    num_frames: int
    device: torch.device
    dtype: torch.dtype = torch.bfloat16
    # run the style branch as one frame per step (its frames are identical;
    # the MMDiT has no per-frame state, so this is exact), its K/V captured
    # by a single-frame forward and injected into the 2-branch batch
    style_singleton: bool = True
    # dp x tp (``with_mesh``): every rank holds the whole input, runs its
    # data shard's frames on its tensor share of the MMDiT
    mesh: Optional[Mesh] = None
    # under a mesh, gather each stage's frame-axis outputs onto every rank
    # (True), or return the rank's shard (False)
    gather: bool = True

    # -- construction --------------------------------------------------------

    @classmethod
    def build(
        cls,
        pretrained_model_path: Optional[str] = None,
        variant: str = "sd3",  # sd3 | sd35 | sd35m | tiny
        num_frames: int = 16,
        dtype: torch.dtype = torch.bfloat16,
        capture_block: Optional[int] = None,
        seed: int = 0,
        device=None,
    ) -> "SD3VideoPipeline":
        """Build every module on ``device`` (CUDA unless the CPU is asked
        for) in ``dtype``; load a checkpoint directory strictly when one is
        given, else random weights from a generator seeded with ``seed``.
        The modules take any size."""
        device = resolve_device(device)
        set_precision()
        mcfg, vcfg, lcfg, gcfg, tcfg, max_seq, clip_len = _configs(variant, capture_block)
        if mcfg.capture_block is not None and not 0 <= mcfg.capture_block < mcfg.num_layers:
            raise ValueError(
                f"--ft_indices {mcfg.capture_block} is outside this model's "
                f"{mcfg.num_layers} transformer blocks (reference default 20 assumes the "
                "24-block SD3-medium; pick a block that exists)")
        with torch.device(device), _default_dtype(dtype):
            mmdit, vae = MMDiT(mcfg), AutoencoderKL(vcfg)
            clip_l, clip_g, t5 = CLIPTextModel(lcfg), CLIPTextModel(gcfg), T5Encoder(tcfg)
        modules = (mmdit, vae, clip_l, clip_g, t5)
        tok_dir = t5_dir = None
        if pretrained_model_path:
            load_pretrained(pretrained_model_path, transformer=mmdit, vae=vae, text_encoder=clip_l,
                            text_encoder_2=clip_g, text_encoder_3=t5)
            td = os.path.join(pretrained_model_path, "tokenizer")
            tok_dir = td if os.path.isdir(td) else None
            t3 = os.path.join(pretrained_model_path, "tokenizer_3")
            t5_dir = t3 if os.path.isdir(t3) else None
        else:
            gen = torch.Generator(device=device).manual_seed(seed)
            for m in modules:
                random_init_(m, gen)
        for m in modules:
            m.to(dtype).eval().requires_grad_(False)
        return cls(mmdit=mmdit, vae=vae, clip_l=clip_l, clip_g=clip_g, t5=t5,
                   tokenizer=Tokenizer(tok_dir, max_len=clip_len),
                   tokenizer_3=T5TokenizerShim(t5_dir, max_len=max_seq),
                   schedule=FlowMatchSchedule(FlowMatchConfig()), num_frames=num_frames,
                   device=device, dtype=dtype)

    def with_frames(self, num_frames: int) -> "SD3VideoPipeline":
        """The same modules driven at another frame count (the single-frame
        style inversion shares the content pipeline's weights)."""
        return dataclasses.replace(self, num_frames=num_frames)

    # -- dp x tp ------------------------------------------------------------------

    def with_mesh(self, mesh: Optional[Mesh], gather: bool = True) -> "SD3VideoPipeline":
        """The pipeline on ``mesh`` (the counterpart of
        univst_tpu/pipelines/sd3.py:225-246): the modules are replicated from
        rank 0 (the text encoders too, unless freed), then the MMDiT's
        linears split over the tensor axis, in place
        (``distributed.tp.shard_mmdit``). Every stage then takes the whole
        input on every rank, runs its data shard's frames (``_shard``; a
        frame count that does not divide the data axis, such as the
        single-frame style forwards, runs on every data rank) and gathers
        its frame-axis outputs (``gather=False``: returns the shard)."""
        if mesh is None:
            return self
        for m in (self.mmdit, self.vae, self.clip_l, self.clip_g, self.t5):
            if m is not None:
                replicate(m, mesh)
        shard_mmdit(self.mmdit, mesh)
        return dataclasses.replace(self, mesh=mesh, gather=gather)

    def _video_ctx(self) -> VideoCtx:
        """The video context of a whole-clip forward: the rank's share and
        its ``shard`` under a data axis."""
        shard = self._frame_shard()
        return VideoCtx(num_frames=self.num_frames if shard is None else shard.local,
                        frame_indices=SD3_FRAME_INDICES, shard=shard)

    # -- text -----------------------------------------------------------------

    def free_text_encoders(self) -> None:
        """Release the text encoders (T5-XXL alone is 9.5 GB in bf16): prompts
        are encoded once per run, before the denoise loops. encode_prompt
        raises after this."""
        self.clip_l = self.clip_g = self.t5 = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.inference_mode()
    def encode_prompt(self, prompt: str):
        """-> (context ``[1, 2*77 + 256, 4096]``, pooled ``[1, 2048]``), fp32
        (diffusers SD3 encode_prompt: clip = cat([clip_l_h, clip_g_h],
        features) zero-padded to the T5 width; context = cat([clip, t5],
        tokens); pooled = cat([pooled_l, pooled_g]))."""
        if self.t5 is None:
            raise RuntimeError("the text encoders were freed (free_text_encoders)")
        ids = torch.as_tensor(self.tokenizer(prompt), dtype=torch.long, device=self.device)
        ids3 = torch.as_tensor(self.tokenizer_3(prompt), dtype=torch.long, device=self.device)
        # the penultimate CLIP hidden state (diffusers clip_skip=None)
        hl, pl = self.clip_l(ids, -2)
        hg, pg = self.clip_g(ids, -2)
        ht = self.t5(ids3)
        clip = torch.cat([hl, hg], dim=-1).float()
        clip = F.pad(clip, (0, self.mmdit.cfg.joint_attention_dim - clip.shape[-1]))
        return torch.cat([clip, ht.float()], dim=1), torch.cat([pl, pg], dim=-1).float()

    # -- vae -------------------------------------------------------------------

    @torch.inference_mode()
    def encode_frames(self, frames, generator: Optional[torch.Generator] = None, noise=None):
        """``[F, H, W, 3]`` in [-1, 1] -> normalized latents ``[F, h, w, 16]``
        fp32, ``(z - shift) * scale`` (flow_inversion.py:29-30). ``noise``
        overrides the posterior draw from ``generator``. Under a data axis
        each rank encodes its frames (the encoder is per frame) and takes its
        slice of the whole clip's draw."""
        x = torch.as_tensor(np.asarray(frames), device=self.device)
        nf, shard = x.shape[0], self._frame_shard(x.shape[0])
        mean, logvar = self.vae.encode(self._shard(x, num_frames=nf).to(self.dtype))
        if shard is not None:
            if noise is None:
                noise = torch.randn((nf,) + tuple(mean.shape[1:]), generator=generator,
                                    device=mean.device, dtype=torch.float32)
            noise = self._shard(torch.as_tensor(noise), num_frames=nf)
        z = sample_latent(mean.float(), logvar.float(), generator, noise)
        return self._gather((z - self.vae.cfg.shift_factor) * self.vae.cfg.scaling_factor, shard)

    @torch.inference_mode()
    def decode_latents(self, latents, chunk: Optional[int] = None):
        """Latents ``[F, h, w, 16]`` -> frames ``[F, H, W, 3]`` in [0, 1]
        (fp32). The SD3 decoder mixes no frames, so ``chunk`` frames at a time
        give the same frames with a smaller peak of activation memory, and
        under a data axis each rank decodes its frames."""
        cfg = self.vae.cfg
        shard = self._frame_shard(latents.shape[0])
        latents = self._shard(latents, num_frames=latents.shape[0])
        z = (latents.to(self.device).float() / cfg.scaling_factor + cfg.shift_factor).to(self.dtype)
        step = z.shape[0] if not chunk else chunk
        px = torch.cat([self.vae.decode(z[s:s + step]) for s in range(0, z.shape[0], step)])
        return self._gather(torch.clamp(px.float() / 2.0 + 0.5, 0.0, 1.0), shard)

    def decode_latents_uint8(self, latents, chunk: Optional[int] = None):
        return torch.round(self.decode_latents(latents, chunk) * 255.0).to(torch.uint8)

    # -- denoiser ---------------------------------------------------------------

    def _cast(self, *xs):
        return tuple(x.to(self.device, self.dtype) for x in xs)

    def _denoise_fn(self, context, pooled, style_cfg: Optional[StyleShiftConfig]):
        vctx = self._video_ctx()
        context, pooled = self._cast(context, pooled)

        def denoise(latents, t, step_idx):
            sctx = StyleCtx(step_idx=step_idx, cfg=style_cfg) if style_cfg is not None else None
            v, feat = self.mmdit(latents.to(self.dtype), t, context, pooled, vctx, sctx)
            return v.float(), feat

        return denoise

    def _mu(self, height_latent: int, width_latent: int) -> Optional[float]:
        if not self.schedule.cfg.use_dynamic_shifting:
            return None
        p = self.mmdit.cfg.patch_size
        return calculate_shift((height_latent // p) * (width_latent // p))

    # -- workflows ---------------------------------------------------------------

    @torch.inference_mode()
    def invert(self, img_latents, context, pooled, num_steps: int = 50,
               is_rf_solver: bool = False, capture_step: Optional[int] = None,
               gamma: float = 0.0, target_noise=None):
        """RF-Inversion / RF-Solver inversion -> (trajectory ``[N+1, F, h, w,
        16]``, captured feature ``[F, h/2, w/2, D]`` or None) (reference
        flow_inversion.py:122-264). ``gamma > 0`` pulls toward
        ``target_noise``, which the caller draws for the whole clip (a rank
        takes its slice). Under a data axis the trajectory and the feature
        are sharded on their frame axes and gathered."""
        mu = self._mu(*img_latents.shape[1:3])
        shard = self._frame_shard()
        latents = self._shard(img_latents).to(self.device).float()
        if self.mmdit.cfg.capture_block is None:
            capture_step = None
        denoise = self._denoise_fn(self._replicated(context), self._replicated(pooled), None)
        if is_rf_solver:
            traj, feat = inv.rf_solver_invert(denoise, latents, self.schedule, num_steps,
                                              capture_step=capture_step, mu=mu)
        else:
            noise = (None if target_noise is None
                     else self._shard(target_noise).to(self.device).float())
            traj, feat = inv.rf_invert(denoise, latents, self.schedule, num_steps, gamma=gamma,
                                       target_noise=noise, capture_step=capture_step, mu=mu)
        return self._gather(traj, shard, axis=1), self._gather(feat, shard)

    @torch.inference_mode()
    def reconstruct_latents(self, inversed_latents, img_latents, context, pooled,
                            num_steps: int = 50, eta_base: float = 0.85,
                            eta_trend: str = "constant", start_step: int = 25,
                            end_step: int = 39):
        """Controlled-velocity reconstruction x1 -> x0 (custom_pipeline.py:46-124)."""
        mu = self._mu(*img_latents.shape[1:3])
        start_step, end_step = scale_eta_window(start_step, end_step, num_steps)
        etas = generate_eta_values(self.schedule.timesteps(num_steps, mu=mu), start_step,
                                   end_step, eta_base, eta_trend)
        shard = self._frame_shard()
        denoise = self._denoise_fn(self._replicated(context), self._replicated(pooled), None)
        return self._gather(inv.rf_sample_controlled(
            denoise, self._shard(inversed_latents).to(self.device).float(),
            self._shard(img_latents).to(self.device).float(), self.schedule, num_steps, etas,
            mu=mu), shard)

    @torch.inference_mode()
    def stylize_latents(self, content_traj_rev, style_traj_rev, init_latents, img_latents,
                        context3, pooled3, mask=None,
                        cfg: StyleTransferConfig = StyleTransferConfig(),
                        style_cfg: StyleShiftConfig = SD3_STYLE_SHIFT):
        """Stylization with the controlled velocity (custom_pipeline.py:126-371).

        Phase 1 (steps before ``style_cfg.window_end()``) runs the 2-branch
        [content | stylized] batch with the single-frame style K/V injected
        (``style_singleton``), or the 3-branch batch; phase 2 — past the shift
        window, where the content/style forwards are dead compute (the
        reference keeps only the stylized velocity, custom_pipeline.py:317-320)
        — runs the stylized branch alone.

        Under a data axis the trajectories (frame axis 1), the initial and
        clean latents and the mask (axis 0) are sharded, the text context
        replicated; the single-frame style capture forward runs on every
        rank (each on its tensor share of the heads).
        """
        n = cfg.num_steps
        mu = self._mu(*init_latents.shape[1:3])
        sigmas = self.schedule.sigmas(n, mu=mu)
        e_start, e_end = scale_eta_window(cfg.eta_start_step, cfg.eta_end_step, n)
        etas = generate_eta_values(self.schedule.timesteps(n, mu=mu), e_start, e_end,
                                   cfg.eta_base, cfg.eta_trend)
        dev = self.device
        shard = self._frame_shard()
        content = self._shard(content_traj_rev, axis=1).to(dev)
        style = self._shard(style_traj_rev, axis=1).to(dev)
        context3, pooled3 = self._replicated(context3), self._replicated(pooled3)
        if self.style_singleton:
            style = style[:, :1]
        elif style.shape[1] == 1 and self.num_frames > 1:
            style = style.expand(-1, content.shape[1], -1, -1, -1)
        mask = None if mask is None else self._shard(torch.as_tensor(mask, device=dev))
        img = self._shard(img_latents).to(dev).float()
        latents = self._shard(init_latents).to(dev).float()
        phase1, phase2 = phase_segments(n, style_cfg.window_end())
        seg = dict(content=content, style=style, sigmas=sigmas, etas=etas, img=img, mask=mask,
                   cfg=cfg)
        for s0, c in phase1:
            if self.style_singleton:
                latents = self._stylize2_segment(latents, s0, c, context3, pooled3, style_cfg,
                                                 **seg)
            else:
                latents = self._stylize3_segment(latents, s0, c, context3, pooled3, style_cfg,
                                                 **seg)
        for s0, c in phase2:
            latents = self._stylize1_segment(latents, s0, c, context3, pooled3, **seg)
        return self._gather(latents, shard)

    def _steps(self, denoise, latents, s0, c, content, style, sigmas, etas, img, mask, cfg,
               **kw):
        sl = slice(s0, s0 + c)
        return style_transfer_rf_steps(
            denoise, content[sl], style[sl], latents, range(s0, s0 + c), sigmas[s0:s0 + c],
            sigmas[s0 + 1:s0 + c + 1], etas[sl], img, self.schedule, cfg, mask=mask, **kw)

    def _stylize3_segment(self, latents, s0, c, context3, pooled3, style_cfg, **seg):
        """Phase-1 segment, 3-branch [content | style | stylized] batch (the
        fallback for a style trajectory whose frames differ)."""
        denoise = self._denoise_fn(context3, pooled3, style_cfg)
        return self._steps(lambda x3, t, i: denoise(x3, t, i)[0], latents, s0, c, **seg)

    def _stylize2_segment(self, latents, s0, c, context3, pooled3, style_cfg, **seg):
        """Phase-1 segment on the style-singleton path: per step, the style
        branch's single-frame forward in capture mode, then the 2-branch
        [content | stylized] forward with its per-block K/V injected."""
        ctx2, pooled2 = self._cast(context3[0::2], pooled3[0::2])
        ctx1, pooled1 = self._cast(context3[1:2], pooled3[1:2])
        vctx = self._video_ctx()
        vctx1 = VideoCtx(num_frames=1, frame_indices=())

        def denoise2(x2, t, i, sty_lat):
            cap = StyleCtx(step_idx=i, cfg=style_cfg, capture=True)
            self.mmdit(sty_lat.to(self.dtype), t, ctx1, pooled1, vctx1, cap)
            sctx = StyleCtx(step_idx=i, cfg=style_cfg,
                            style_kv=extract_mmdit_style_kv(cap.captured))
            v, _ = self.mmdit(x2.to(self.dtype), t, ctx2, pooled2, vctx, sctx)
            return v.float()

        return self._steps(denoise2, latents, s0, c, singleton=True, **seg)

    def _stylize1_segment(self, latents, s0, c, context3, pooled3, **seg):
        """Phase-2 segment, the stylized branch alone: the shift gate is off,
        so the attention uses the branch's own q/k/v; the cross-frame K/V
        still applies (the SD3 processors sit on every layer regardless of the
        window, run_content_inversion_sd3.py:58-68), and so do the
        controlled-velocity pull and the mask blend."""
        denoise = self._denoise_fn(context3[2:3], pooled3[2:3], None)
        return self._steps(lambda x, t, i: denoise(x, t, i)[0], latents, s0, c, solo=True,
                           **seg)
