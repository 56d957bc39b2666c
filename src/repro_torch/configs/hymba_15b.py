"""hymba-1.5b — 32L d=1600 25H GQA(kv=5) hd=64 d_ff=5504 V=32001,
parallel attn∥Mamba heads, ssm_state=16, SWA(1024) with full attention at
layers {0, 15, 31}.

[arXiv:2411.13676; hf]. Runs long_500k (hybrid: bounded-window KV + O(1)
SSM state). V=32001 is not 16-divisible → embedding shards its d_model axis
instead (sharding fallback rule).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
        head_dim=64, d_ff=5504, vocab_size=32_001,
        act="silu", mlp_type="glu", norm_type="rmsnorm",
        tie_embeddings=True,
        sliding_window=1024, global_layers=(0, 15, 31),
        ssm_state=16, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
        ssm_conv=4, rope_theta=10_000.0, max_seq_len=524_288,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", family="hybrid",
        num_layers=5, d_model=128, num_heads=2, num_kv_heads=1,
        head_dim=64, d_ff=256, vocab_size=512,
        act="silu", mlp_type="glu", tie_embeddings=True,
        sliding_window=32, global_layers=(0, 2, 4),
        ssm_state=16, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
        ssm_conv=4, max_seq_len=128, attn_chunk=32, logits_chunk=32,
        ssm_chunk=32,
    )
