"""glm4-9b — 40L d=4096 32H GQA(kv=2) hd=128 d_ff=13696 V=151552.

[hf:THUDM/glm-4-9b; hf]. Partial rotary (half the head dims), SwiGLU,
QKV bias, untied head.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
        head_dim=128, d_ff=13696, vocab_size=151_552,
        act="silu", mlp_type="glu", norm_type="rmsnorm",
        rope_fraction=0.5, qkv_bias=True, tie_embeddings=False,
        rope_theta=10_000.0, max_seq_len=32_768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b-smoke", family="dense",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512,
        act="silu", mlp_type="glu", rope_fraction=0.5, qkv_bias=True,
        max_seq_len=128, attn_chunk=32, logits_chunk=32,
    )
