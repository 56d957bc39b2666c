"""deepseek-v2-lite-16b — 27L d=2048, MLA (kv_lora=512, rope/nope split
heads 64+128, v=128), MoE 64 routed top-6 + 2 shared, first layer dense.

[arXiv:2405.04434; hf]. Assignment note (DESIGN.md §4): the spec line reads
"MoE 64e top-6" with a prose mention of 160 routed; we follow the bracketed
64-expert figure. MLA decode uses the absorbed form with a latent cache
(models/mla.py).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=192, d_ff=10944, vocab_size=102_400,
        act="silu", mlp_type="glu", norm_type="rmsnorm",
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128,
        num_experts=64, top_k=6, moe_d_ff=1408, num_shared_experts=2,
        first_dense_layers=1, norm_topk_prob=True,
        rope_theta=10_000.0, max_seq_len=32_768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke", family="moe",
        num_layers=3, d_model=128, num_heads=2, num_kv_heads=2,
        head_dim=96, d_ff=256, vocab_size=512,
        act="silu", mlp_type="glu",
        kv_lora_rank=64, qk_nope_head_dim=64, qk_rope_head_dim=32,
        v_head_dim=64,
        num_experts=8, top_k=2, moe_d_ff=128, num_shared_experts=1,
        first_dense_layers=1, norm_topk_prob=True, capacity_factor=2.0,
        max_seq_len=128, attn_chunk=32, logits_chunk=32,
    )
