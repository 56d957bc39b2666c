"""mamba2-130m — 24L d=768, attention-free SSD, ssm_state=128, V=50280.

[arXiv:2405.21060; unverified]. expand=2 → d_inner=1536, headdim=64 →
24 SSM heads, 1 B/C group, conv window 4. Tied embeddings. Attention-free →
constant-size decode state → runs long_500k natively.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        num_layers=24, d_model=768, num_heads=12, num_kv_heads=12,
        head_dim=64, d_ff=0, vocab_size=50_280,
        norm_type="rmsnorm", tie_embeddings=True,
        ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
        ssm_conv=4, ssm_chunk=256, max_seq_len=524_288,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        num_layers=2, d_model=128, num_heads=2, num_kv_heads=2,
        head_dim=64, d_ff=0, vocab_size=512,
        tie_embeddings=True,
        ssm_state=16, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
        ssm_conv=4, ssm_chunk=32, max_seq_len=128, attn_chunk=32,
        logits_chunk=32,
    )
