"""gemma3-4b — 34L d=2560 8H GQA(kv=4) hd=256 d_ff=10240 V=262144.

[hf:google/gemma-3-4b-pt; unverified]. 5:1 local:global interleave (sliding
window 1024, layer (i+1)%6==0 is global), QK-norm, dual rope theta (1M
global / 10k local), gemma norm/embedding conventions. Runs long_500k:
29/34 layers are windowed (sub-quadratic); the 5 global layers are O(S) per
decode step, which is the decode regime anyway (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", family="dense",
        num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4,
        head_dim=256, d_ff=10240, vocab_size=262_144,
        act="gelu", mlp_type="glu", norm_type="rmsnorm",
        rms_plus_one=True, scale_embed=True, tie_embeddings=True,
        qk_norm=True, sliding_window=1024, global_every=6,
        rope_theta=1_000_000.0, local_rope_theta=10_000.0,
        max_seq_len=524_288,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b-smoke", family="dense",
        num_layers=7, d_model=128, num_heads=2, num_kv_heads=2,
        head_dim=64, d_ff=256, vocab_size=512,
        act="gelu", mlp_type="glu", rms_plus_one=True, scale_embed=True,
        tie_embeddings=True, qk_norm=True, sliding_window=32,
        global_every=3, rope_theta=1_000_000.0, local_rope_theta=10_000.0,
        max_seq_len=128, attn_chunk=32, logits_chunk=32,
    )
