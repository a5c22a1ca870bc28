"""The SD-1.5 family under test: the port's ``SDVideoPipeline`` with the
benchmark's weights, driven as a user drives it.

Built as ``SDVideoPipeline.build`` builds it (the UNet, the SVD temporal VAE
and CLIP-L, bf16, ``set_precision``), except that the parameters take the
benchmark's seeded values (``benchmark/weights.py``) in place of the
pipeline's own random init: the reference gets the same values.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark import weights
from benchmark.reference import sd as ref_sd

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@contextlib.contextmanager
def default_dtype(dtype):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def latent_channels(cfg: dict) -> int:
    return cfg["vae"]["latent_channels"]


def reference_spec(cfg: dict) -> dict:
    return weights.spec(ref_sd.build(cfg, None, meta=True).named_parameters())


class System:
    """The pipeline and its prepared conditioning; ``clip`` is the timed
    path of one stylization job."""

    def __init__(self, cfg: dict, traffic: dict, device, seed: int):
        from univst_torch.core.scheduler import DDIMConfig, DDIMSchedule
        from univst_torch.models.clip_text import CLIPTextConfig, CLIPTextModel, Tokenizer
        from univst_torch.models.unet_sd import UNetPseudo3D, UNetSDConfig
        from univst_torch.models.vae import AutoencoderKL, VAEConfig
        from univst_torch.pipelines.sd import SDVideoPipeline, set_precision

        u, v, t = cfg["unet"], cfg["vae"], cfg["text_encoder"]
        dtype = DTYPES[cfg["torch_dtype"]]
        set_precision()
        ucfg = UNetSDConfig(
            in_channels=u["in_channels"], out_channels=u["out_channels"],
            block_out_channels=tuple(u["block_out_channels"]),
            layers_per_block=u["layers_per_block"],
            num_heads=(u["attention_head_dim"],) * len(u["block_out_channels"]),
            cross_attention_dim=u["cross_attention_dim"], norm_num_groups=u["norm_num_groups"],
            down_block_has_attn=tuple("CrossAttn" in s for s in u["down_block_types"]),
            up_block_has_attn=tuple("CrossAttn" in s for s in u["up_block_types"]))
        vcfg = VAEConfig(block_out_channels=tuple(v["block_out_channels"]),
                         layers_per_block=v["layers_per_block"],
                         latent_channels=v["latent_channels"], norm_num_groups=v["norm_num_groups"],
                         scaling_factor=v["scaling_factor"], temporal_decoder=True)
        tcfg = CLIPTextConfig(vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
                              num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
                              max_positions=t["max_position_embeddings"],
                              intermediate_size=t["intermediate_size"], hidden_act=t["hidden_act"])
        with torch.device(device), default_dtype(dtype):
            unet, vae, text = UNetPseudo3D(ucfg), AutoencoderKL(vcfg), CLIPTextModel(tcfg)
        params = {}
        for prefix, m in (("unet", unet), ("vae", vae), ("text_encoder", text)):
            params.update({f"{prefix}.{k}": p for k, p in m.named_parameters()})
        weights.check_spec(reference_spec(cfg), weights.spec(params.items()), "sd")
        weights.fill(params, weights.sub_seed(seed, "weights"), device)
        for m in (unet, vae, text):
            m.to(dtype).eval().requires_grad_(False)
        self.pipe = SDVideoPipeline(
            unet=unet, vae=vae, text_encoder=text, tokenizer=Tokenizer(None),
            schedule=DDIMSchedule(DDIMConfig()), num_frames=traffic["frames"], device=device,
            dtype=dtype)
        self.context3 = torch.cat([self.pipe.encode_text("")] * 3)

    def norm_roots(self):
        return (self.pipe.unet, self.pipe.vae)

    def stylize(self, inputs: dict, traffic: dict, steps=None):
        from univst_torch.core.config import StyleTransferConfig

        return self.pipe.stylize_latents(
            inputs["content"], inputs["style"], inputs["init"], self.context3,
            mask=inputs["mask"], cfg=StyleTransferConfig(num_steps=steps or traffic["steps"]))

    def decode(self, latents, traffic: dict):
        """uint8 frames on the host (the copy waits for the card)."""
        chunks = self.pipe.decode_latents_uint8_chunks(latents, chunk=traffic["decode_chunk"])
        return torch.cat([c.cpu() for c in chunks])

    def warmup(self, inputs: dict, traffic: dict) -> None:
        """Every shape a job runs: ``warmup_steps`` steps and the decode. The
        style pre-pass's rows and the phase split come from the shift window
        (50-step constants), not from the step count, so the fewest steps
        that reach one step past the window (27 for SD-1.5) run the
        pre-pass at its full size, each phase-1 step and a phase-2 step."""
        self.decode(self.stylize(inputs, traffic, traffic["warmup_steps"]), traffic)


def reference_clip(cfg: dict, traffic: dict, inputs: dict, seed: int, device, control=None,
                   dtype=None):
    """The reference's stylized latents and uint8 frames of one clip, with
    the run's weights (``control``: one of ``reference.common.CONTROLS``)."""
    from benchmark.reference.common import control as control_on

    model = ref_sd.build(cfg, device, dtype or DTYPES[cfg["torch_dtype"]])
    weights.fill(dict(model.named_parameters()), weights.sub_seed(seed, "weights"), device)
    with control_on(model, control), torch.no_grad():
        return ref_sd.clip_frames(model, inputs, traffic)


def clip_flops(cfg: dict, traffic: dict) -> float:
    """Matmul, convolution and attention FLOPs of one stylization job, counted
    on the reference on the meta device: the shift window's steps as a
    2-video [content | stylized] forward plus the style branch once as one
    frame (its frames are one latent repeated), the other steps as one
    video, then the decode. Duplicate attention slots count once."""
    from benchmark.roofline import FlopCount

    model = ref_sd.build(cfg, None, meta=True)
    m, f, n = cfg["method"], traffic["frames"], traffic["steps"]
    size = traffic["size"]
    h, c = size // traffic["latent_downsample"], latent_channels(cfg)
    lo, hi = m["shift_window"]
    k1 = len([i for i in range(n) if lo <= i <= hi])
    ctx = torch.empty(1, 77, cfg["unet"]["cross_attention_dim"], device="meta")

    def unet(b, frames):
        run = dict(frames=frames, step=0, method=m, stylize=True, shift=False,
                   indices=tuple(m["frame_indices"]), pnp_indices=tuple(m["pnp_frame_indices"]))
        with FlopCount() as fc, torch.no_grad():
            model.unet(torch.empty(b * frames, c, h, h, device="meta"), 1.0,
                       ctx.expand(b * frames, -1, -1), run)
        return fc.total

    with FlopCount() as fc, torch.no_grad():
        model.decode_uint8(torch.empty(f, h, h, c, device="meta"), traffic["decode_chunk"])
    return float(k1 * (unet(2, f) + unet(1, 1)) + (n - k1) * unet(1, f) + fc.total)
