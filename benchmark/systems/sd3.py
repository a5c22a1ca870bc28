"""The SD3 family under test: the port's ``SD3VideoPipeline`` with the
benchmark's weights, driven as a user drives it.

Built as ``SD3VideoPipeline.build`` builds it (the MMDiT, the 16-channel VAE,
CLIP-L, CLIP-bigG and T5-XXL, every module on the card in bf16,
``set_precision``), except that the parameters take the benchmark's seeded
values in place of the pipeline's own random init. The empty prompt is
encoded once in set-up; then the text encoders are freed, as a run of the
SD3 CLIs does before its denoise loops.
"""

from __future__ import annotations

import torch

from benchmark import weights
from benchmark.reference import sd3 as ref_sd3
from benchmark.systems.sd import DTYPES, default_dtype


def latent_channels(cfg: dict) -> int:
    return cfg["vae"]["latent_channels"]


def reference_spec(cfg: dict) -> dict:
    return weights.spec(ref_sd3.build(cfg, None, meta=True).named_parameters())


def _clip_cfg(c: dict):
    from univst_torch.models.clip_text import CLIPTextConfig

    return CLIPTextConfig(vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
                          num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
                          max_positions=c["max_position_embeddings"],
                          intermediate_size=c["intermediate_size"], hidden_act=c["hidden_act"],
                          projection_dim=c["projection_dim"])


class System:
    """The pipeline with its encoded prompt; ``stylize`` then ``decode`` is
    the timed path of one job."""

    def __init__(self, cfg: dict, traffic: dict, device, seed: int):
        from univst_torch.core.scheduler import FlowMatchConfig, FlowMatchSchedule
        from univst_torch.models.clip_text import CLIPTextModel, Tokenizer
        from univst_torch.models.mmdit import MMDiT, MMDiTConfig
        from univst_torch.models.t5 import T5Config, T5Encoder, T5TokenizerShim
        from univst_torch.models.vae import AutoencoderKL, VAEConfig
        from univst_torch.pipelines.sd import set_precision
        from univst_torch.pipelines.sd3 import SD3VideoPipeline

        t, v, t5 = cfg["transformer"], cfg["vae"], cfg["text_encoder_3"]
        dtype = DTYPES[cfg["torch_dtype"]]
        set_precision()
        mcfg = MMDiTConfig(
            patch_size=t["patch_size"], in_channels=t["in_channels"],
            out_channels=t["out_channels"], num_layers=t["num_layers"],
            num_heads=t["num_attention_heads"], head_dim=t["attention_head_dim"],
            joint_attention_dim=t["joint_attention_dim"],
            pooled_projection_dim=t["pooled_projection_dim"],
            pos_embed_max_size=t["pos_embed_max_size"])
        vcfg = VAEConfig(block_out_channels=tuple(v["block_out_channels"]),
                         layers_per_block=v["layers_per_block"],
                         latent_channels=v["latent_channels"], norm_num_groups=v["norm_num_groups"],
                         scaling_factor=v["scaling_factor"], shift_factor=v["shift_factor"])
        tcfg = T5Config(vocab_size=t5["vocab_size"], d_model=t5["d_model"], d_ff=t5["d_ff"],
                        num_layers=t5["num_layers"], num_heads=t5["num_heads"],
                        head_dim=t5["d_kv"], rel_buckets=t5["relative_attention_num_buckets"],
                        rel_max_distance=t5["relative_attention_max_distance"])
        with torch.device(device), default_dtype(dtype):
            mods = dict(transformer=MMDiT(mcfg), vae=AutoencoderKL(vcfg),
                        text_encoder=CLIPTextModel(_clip_cfg(cfg["text_encoder"])),
                        text_encoder_2=CLIPTextModel(_clip_cfg(cfg["text_encoder_2"])),
                        text_encoder_3=T5Encoder(tcfg))
        params = {f"{p}.{k}": x for p, m in mods.items() for k, x in m.named_parameters()}
        weights.check_spec(reference_spec(cfg), weights.spec(params.items()), "sd3")
        weights.fill(params, weights.sub_seed(seed, "weights"), device)
        for m in mods.values():
            m.to(dtype).eval().requires_grad_(False)
        self.pipe = SD3VideoPipeline(
            mmdit=mods["transformer"], vae=mods["vae"], clip_l=mods["text_encoder"],
            clip_g=mods["text_encoder_2"], t5=mods["text_encoder_3"],
            tokenizer=Tokenizer(None, max_len=cfg["clip_max_length"]),
            tokenizer_3=T5TokenizerShim(None, max_len=cfg["t5_max_length"]),
            schedule=FlowMatchSchedule(FlowMatchConfig(shift=cfg["scheduler"]["shift"])),
            num_frames=traffic["frames"], device=device, dtype=dtype)
        context, pooled = self.pipe.encode_prompt("")
        self.pipe.free_text_encoders()
        self.context3, self.pooled3 = torch.cat([context] * 3), torch.cat([pooled] * 3)

    def norm_roots(self):
        return (self.pipe.mmdit, self.pipe.vae)

    def stylize(self, inputs: dict, traffic: dict, steps=None):
        from univst_torch.core.config import StyleTransferConfig

        return self.pipe.stylize_latents(
            inputs["content"], inputs["style"], inputs["init"], inputs["content"][0],
            self.context3, self.pooled3, mask=inputs["mask"],
            cfg=StyleTransferConfig(num_steps=steps or traffic["steps"]))

    def decode(self, latents, traffic: dict):
        """uint8 frames on the host (the copy waits for the card), decoded
        ``decode_chunk`` frames a call, as the SD3 CLIs decode."""
        return self.pipe.decode_latents_uint8(latents, chunk=traffic["decode_chunk"]).cpu()

    def warmup(self, inputs: dict, traffic: dict) -> None:
        """Every shape a job runs: each step of the window has the same
        shapes, so ``warmup_steps`` steps and the decode cover them."""
        self.decode(self.stylize(inputs, traffic, traffic["warmup_steps"]), traffic)


def reference_clip(cfg: dict, traffic: dict, inputs: dict, seed: int, device, control=None,
                   dtype=None):
    """The reference's stylized latents and uint8 frames of one job, with
    the run's weights (``control``: one of ``reference.common.CONTROLS``).
    The text encoders are freed once the prompt is encoded."""
    from benchmark.reference.common import control as control_on

    model = ref_sd3.build(cfg, device, dtype or DTYPES[cfg["torch_dtype"]])
    weights.fill(dict(model.named_parameters()), weights.sub_seed(seed, "weights"), device)
    with control_on(model, control), torch.no_grad():
        prompt = model.prompt()
        model.text_encoder = model.text_encoder_2 = model.text_encoder_3 = None
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        return ref_sd3.clip_frames(model, inputs, traffic, prompt)


def clip_flops(cfg: dict, traffic: dict) -> float:
    """Matmul, convolution and attention FLOPs of one stylization job,
    counted on the reference on the meta device: each shift-window step a
    one-frame style forward and a 2-video [content | stylized] forward, the
    other steps one video, then the decode. Duplicate attention slots
    count once."""
    from benchmark.roofline import FlopCount

    model = ref_sd3.build(cfg, None, meta=True)
    m, f, n = cfg["method"], traffic["frames"], traffic["steps"]
    h, c = traffic["size"] // traffic["latent_downsample"], latent_channels(cfg)
    lo, hi = m["shift_window"]
    k1 = len([i for i in range(n) if lo <= i <= hi])
    t = cfg["transformer"]
    ctx = torch.empty(1, cfg["clip_max_length"] + cfg["t5_max_length"], t["joint_attention_dim"], device="meta")
    pooled = torch.empty(1, t["pooled_projection_dim"], device="meta")

    def mmdit(b, frames):
        run = dict(method=m, frames=frames, indices=tuple(m["frame_indices"]) if frames > 1
                   else (), shift=False, step=0)
        rows = b * frames
        with FlopCount() as fc, torch.no_grad():
            model.transformer(torch.empty(rows, h, h, c, device="meta"), 1.0,
                              ctx.expand(rows, -1, -1), pooled.expand(rows, -1), run)
        return fc.total

    with FlopCount() as fc, torch.no_grad():
        model.decode_uint8(torch.empty(f, h, h, c, device="meta"), f)
    return float(k1 * (mmdit(2, f) + mmdit(1, 1)) + (n - k1) * mmdit(1, f) + fc.total)
