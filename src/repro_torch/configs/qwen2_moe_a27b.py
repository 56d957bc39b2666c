"""qwen2-moe-a2.7b — 24L d=2048 16H MHA d_ff(expert)=1408 V=151936,
MoE 60 routed top-4 + 4 shared experts with sigmoid gate.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]. QKV bias (qwen convention).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=5632, vocab_size=151_936,
        act="silu", mlp_type="glu", norm_type="rmsnorm",
        qkv_bias=True, tie_embeddings=False,
        num_experts=60, top_k=4, moe_d_ff=1408, num_shared_experts=4,
        shared_expert_gate=True, norm_topk_prob=False,
        rope_theta=1_000_000.0, max_seq_len=32_768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke", family="moe",
        num_layers=2, d_model=128, num_heads=2, num_kv_heads=2,
        head_dim=64, d_ff=256, vocab_size=512,
        act="silu", mlp_type="glu", qkv_bias=True,
        num_experts=8, top_k=2, moe_d_ff=128, num_shared_experts=2,
        shared_expert_gate=True, capacity_factor=2.0,
        max_seq_len=128, attn_chunk=32, logits_chunk=32,
    )
