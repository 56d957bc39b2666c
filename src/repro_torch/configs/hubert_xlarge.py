"""hubert-xlarge — 48L encoder d=1280 16H MHA d_ff=5120, codebook vocab 504.

[arXiv:2106.07447; unverified]. Encoder-only (bidirectional attention, no
decode step → decode_32k/long_500k skipped). The conv waveform frontend is
a stub: the batch holds precomputed frame embeddings
[B, S, 512] which a linear `frame_proj` maps to d_model. Training objective:
masked-unit prediction = CE over the 504-codeword vocabulary. LayerNorm +
plain GELU MLP (wav2vec2 family), no RoPE (rope_fraction=0).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio",
        num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
        head_dim=80, d_ff=5120, vocab_size=504,
        act="gelu", mlp_type="plain", norm_type="layernorm", norm_eps=1e-5,
        rope_fraction=0.0, is_encoder=True,
        frontend="audio", frontend_dim=512,
        tie_embeddings=False, max_seq_len=32_768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke", family="audio",
        num_layers=2, d_model=128, num_heads=2, num_kv_heads=2,
        head_dim=64, d_ff=256, vocab_size=64,
        act="gelu", mlp_type="plain", norm_type="layernorm", norm_eps=1e-5,
        rope_fraction=0.0, is_encoder=True,
        frontend="audio", frontend_dim=32,
        max_seq_len=128, attn_chunk=32, logits_chunk=32,
    )
