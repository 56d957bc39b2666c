"""gemma-2b — 18L d=2048 8H MQA(kv=1) hd=256 d_ff=16384 V=256000, GeGLU.

[arXiv:2403.08295; hf]. Gemma conventions: embeddings scaled by sqrt(d),
RMSNorm weight stored as (1 + gamma), tied lm head, GeGLU MLP, MQA.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b", family="dense",
        num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
        head_dim=256, d_ff=16384, vocab_size=256_000,
        act="gelu", mlp_type="glu", norm_type="rmsnorm",
        rms_plus_one=True, scale_embed=True, tie_embeddings=True,
        rope_theta=10_000.0, max_seq_len=32_768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-smoke", family="dense",
        num_layers=2, d_model=128, num_heads=2, num_kv_heads=1,
        head_dim=64, d_ff=256, vocab_size=512,
        act="gelu", mlp_type="glu", rms_plus_one=True, scale_embed=True,
        tie_embeddings=True, max_seq_len=128, attn_chunk=32,
        logits_chunk=32,
    )
