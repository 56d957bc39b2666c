"""smollm-360m — 32L d=960 15H GQA(kv=5) hd=64 d_ff=2560 V=49152.

[hf:HuggingFaceTB/SmolLM-360M; hf]. Llama-family small model, tied
embeddings, SwiGLU.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense",
        num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
        head_dim=64, d_ff=2560, vocab_size=49_152,
        act="silu", mlp_type="glu", norm_type="rmsnorm",
        tie_embeddings=True, rope_theta=10_000.0, max_seq_len=32_768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m-smoke", family="dense",
        num_layers=2, d_model=192, num_heads=3, num_kv_heads=1,
        head_dim=64, d_ff=256, vocab_size=512,
        act="silu", mlp_type="glu", tie_embeddings=True,
        max_seq_len=128, attn_chunk=32, logits_chunk=32,
    )
