"""qwen2.5-0.5b — the paper's reproduction target.

24L d=896 14H GQA(kv=2) hd=64 d_ff=4864 V=151936, QKV bias, tied
embeddings [Qwen2.5 report / hf:Qwen/Qwen2.5-0.5B].
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen25-05b", family="dense",
        num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
        head_dim=64, d_ff=4864, vocab_size=151_936,
        act="silu", mlp_type="glu", norm_type="rmsnorm",
        qkv_bias=True, tie_embeddings=True,
        rope_theta=1_000_000.0, max_seq_len=32_768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen25-05b-smoke", family="dense",
        num_layers=2, d_model=128, num_heads=2, num_kv_heads=1,
        head_dim=64, d_ff=256, vocab_size=512,
        act="silu", mlp_type="glu", qkv_bias=True, tie_embeddings=True,
        max_seq_len=128, attn_chunk=32, logits_chunk=32,
    )
