"""Tiny configurations and traffic of the benchmark's cells, for the CPU
tests: the same families and keys at widths a CPU runs in seconds."""

import copy

from benchmark.run import Cell

SD = {
    "system": "sd", "torch_dtype": "float32",
    "unet": {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64, 64, 64],
             "layers_per_block": 2, "attention_head_dim": 2, "cross_attention_dim": 32,
             "norm_num_groups": 8,
             "down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
             "up_block_types": ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3,
             "pnp_up_attentions": {"1": [1, 2], "2": [0, 1, 2], "3": [0, 1, 2]}},
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
            "block_out_channels": [16, 32], "layers_per_block": 1, "norm_num_groups": 4,
            "scaling_factor": 0.18215},
    "text_encoder": {"vocab_size": 49408, "hidden_size": 32, "num_hidden_layers": 2,
                     "num_attention_heads": 2, "intermediate_size": 64,
                     "hidden_act": "quick_gelu", "max_position_embeddings": 77},
}
SD_TRAFFIC = {"kind": "stylize", "frames": 4, "size": 64, "latent_downsample": 2, "steps": 8,
              "pool": 2, "decode_chunk": 2, "warmup_steps": 8}


def _clip(proj):
    return {"vocab_size": 49408, "hidden_size": 32, "num_hidden_layers": 2,
            "num_attention_heads": 2, "intermediate_size": 64, "hidden_act": "quick_gelu",
            "max_position_embeddings": 77, "projection_dim": proj}


SD3 = {
    "system": "sd3", "torch_dtype": "float32", "clip_max_length": 7, "t5_max_length": 16,
    "transformer": {"patch_size": 2, "in_channels": 16, "out_channels": 16, "num_layers": 2,
                    "num_attention_heads": 2, "attention_head_dim": 16,
                    "joint_attention_dim": 64, "pooled_projection_dim": 32,
                    "pos_embed_max_size": 16},
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 16,
            "block_out_channels": [16, 32], "layers_per_block": 1, "norm_num_groups": 4,
            "scaling_factor": 1.5305, "shift_factor": 0.0609},
    "text_encoder": _clip(16), "text_encoder_2": _clip(16),
    "text_encoder_3": {"vocab_size": 32128, "d_model": 64, "d_ff": 64, "num_layers": 2,
                       "num_heads": 2, "d_kv": 16, "relative_attention_num_buckets": 32,
                       "relative_attention_max_distance": 128},
}
SD3_TRAFFIC = {"kind": "stylize", "frames": 4, "size": 64, "latent_downsample": 2, "steps": 6,
               "pool": 2, "decode_chunk": 2, "warmup_steps": 2}

TINY = {"sd15_stylize": (SD, SD_TRAFFIC), "sd3m_stylize": (SD3, SD3_TRAFFIC)}


def cell(name: str, dtype: str = "float32") -> Cell:
    """The cell as the manifest defines it, at its tiny size: the tiny
    widths, with the published configuration's scheduler and method."""
    c = Cell(name)
    cfg, traffic = TINY[name]
    cfg = dict(copy.deepcopy(cfg), torch_dtype=dtype, scheduler=c.config["scheduler"],
               method=c.config["method"])
    c.config, c.traffic = cfg, dict(traffic)
    return c
