"""phi-3-vision-4.2b — 32L d=3072 32H MHA hd=96 d_ff=8192 V=32064 + CLIP stub.

[hf:microsoft/Phi-3-vision-128k-instruct; hf]. Backbone = phi3-mini; the
CLIP-ViT frontend is a stub: the batch holds
precomputed patch embeddings [B, 256, 1024], linearly projected and
prepended to the token sequence (labels masked over the image span).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
        head_dim=96, d_ff=8192, vocab_size=32_064,
        act="silu", mlp_type="glu", norm_type="rmsnorm",
        tie_embeddings=False, rope_theta=10_000.0,
        frontend="vision", frontend_dim=1024, num_patches=256,
        max_seq_len=32_768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-vision-smoke", family="vlm",
        num_layers=2, d_model=128, num_heads=2, num_kv_heads=2,
        head_dim=64, d_ff=256, vocab_size=512,
        act="silu", mlp_type="glu",
        frontend="vision", frontend_dim=32, num_patches=8,
        max_seq_len=128, attn_chunk=32, logits_chunk=32,
    )
