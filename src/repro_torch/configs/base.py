"""Model/config schema shared by every architecture (a copy of the
reference package's `configs/base.py`; the port imports nothing of it).

A `ModelConfig` fully determines parameter shapes, the per-layer block kinds
(`layer_kinds()`), and the input pytrees for each assigned shape cell
(`input_specs` lives in `launch/specs.py` so this module stays jax-light).

`LayerKind` is the unit the stack builder groups into scan segments: runs of
identical kinds are scanned over stacked params (compile-time O(1) in run
length), kind changes break segments (gemma3's 5:1 local:global, hymba's
3 full-attention layers, deepseek's first dense layer).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Mixer = Literal["attn", "mla", "mamba", "hymba"]
Mlp = Literal["glu", "plain", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: Mixer = "attn"
    mlp: Mlp = "glu"
    window: int = 0          # 0 = full attention; >0 = sliding-window size
    is_global: bool = True   # False for windowed layers

    @property
    def tag(self) -> str:
        w = f"w{self.window}" if self.window else "full"
        return f"{self.mixer}-{w}-{self.mlp}"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity -------------------------------------------------------------
    name: str = "unnamed"
    family: str = "dense"     # dense | moe | hybrid | ssm | audio | vlm
    # trunk ----------------------------------------------------------------
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 256
    vocab_size: int = 256
    act: str = "silu"              # activation inside the MLP
    mlp_type: str = "glu"          # "glu" (gate*up) | "plain" (single up)
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    norm_eps: float = 1e-6
    rms_plus_one: bool = False     # gemma convention: weight = 1 + gamma
    # attention ------------------------------------------------------------
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0     # glm4: 0.5 (partial rotary)
    local_rope_theta: float = 0.0  # gemma3: different theta on local layers
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0
    global_every: int = 0          # gemma3: layer (i+1) % global_every == 0 is global
    global_layers: tuple[int, ...] = ()  # hymba: explicit global layer ids
    # embeddings -----------------------------------------------------------
    tie_embeddings: bool = False
    scale_embed: bool = False      # gemma: multiply embeddings by sqrt(d)
    # MoE ------------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    shared_expert_gate: bool = False   # qwen2-moe sigmoid gate on shared out
    first_dense_layers: int = 0        # deepseek-v2: layer 0 keeps dense MLP
    norm_topk_prob: bool = False
    router_aux_weight: float = 0.001
    capacity_factor: float = 1.25
    # MLA (deepseek-v2) ------------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba2 / hymba) ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # structure ------------------------------------------------------------
    is_encoder: bool = False
    frontend: str = "none"        # none | audio (hubert) | vision (phi3-v)
    frontend_dim: int = 0         # raw feature dim fed by the stub frontend
    num_patches: int = 0          # vlm: image patch tokens per sample
    max_seq_len: int = 4096
    # numerics ---------------------------------------------------------------
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    kv_quant: str = "none"         # "none" | "int8" — quantized KV cache
                                   # (§Perf A4: decode is cache-bound once
                                   # weights are INT4; per-(token, head)
                                   # absmax scales, KIVI-style)
    logits_chunk: int = 512        # seq chunk for the chunked-vocab CE loss
    attn_chunk: int = 1024         # q-chunk for long-sequence attention
    remat: bool = True

    # ------------------------------------------------------------------ api
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def shared_d_ff(self) -> int:
        return self.num_shared_experts * self.moe_d_ff

    def _is_global(self, i: int) -> bool:
        if self.sliding_window == 0:
            return True
        if self.global_layers:
            return i in self.global_layers
        if self.global_every:
            return (i + 1) % self.global_every == 0
        return False

    def layer_kinds(self) -> tuple[LayerKind, ...]:
        kinds = []
        for i in range(self.num_layers):
            g = self._is_global(i)
            window = 0 if g else self.sliding_window
            if self.family == "ssm":
                kinds.append(LayerKind(mixer="mamba", mlp="none"))
                continue
            mixer: Mixer = "attn"
            if self.kv_lora_rank:
                mixer = "mla"
            elif self.family == "hybrid":
                mixer = "hymba"
            if self.num_experts and i >= self.first_dense_layers:
                mlp: Mlp = "moe"
            else:
                mlp = self.mlp_type  # type: ignore[assignment]
            kinds.append(LayerKind(mixer=mixer, mlp=mlp, window=window,
                                   is_global=g))
        return tuple(kinds)

    def segments(self) -> tuple[tuple[LayerKind, int], ...]:
        """Consecutive runs of identical layer kinds (scan units)."""
        segs: list[tuple[LayerKind, int]] = []
        for kind in self.layer_kinds():
            if segs and segs[-1][0] == kind:
                segs[-1] = (kind, segs[-1][1] + 1)
            else:
                segs.append((kind, 1))
        return tuple(segs)

    def n_params(self) -> int:
        """Analytic parameter count (embedding + per-layer), for rooflines."""
        d = self.d_model
        n = self.vocab_size * d  # embedding
        if not self.tie_embeddings and not self.is_encoder:
            n += d * self.vocab_size
        for kind in self.layer_kinds():
            n += 2 * d  # two norms (approximation: biases/extra norms ~0)
            if kind.mixer == "attn":
                n += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            elif kind.mixer == "mla":
                rope, nope = self.qk_rope_head_dim, self.qk_nope_head_dim
                n += d * self.num_heads * (nope + rope)       # q proj
                n += d * (self.kv_lora_rank + rope)           # kv down
                n += self.kv_lora_rank * self.num_heads * (nope + self.v_head_dim)
                n += self.num_heads * self.v_head_dim * d     # o proj
            elif kind.mixer == "mamba":
                di, ds, nh = self.d_inner, self.ssm_state, self.ssm_nheads
                n += d * (2 * di + 2 * self.ssm_ngroups * ds + nh) + di * d
            elif kind.mixer == "hymba":
                n += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
                di, ds, nh = self.d_inner, self.ssm_state, self.ssm_nheads
                n += d * (2 * di + 2 * self.ssm_ngroups * ds + nh) + di * d
            if kind.mlp == "glu":
                n += 3 * d * self.d_ff
            elif kind.mlp == "plain":
                n += 2 * d * self.d_ff
            elif kind.mlp == "moe":
                n += d * self.num_experts  # router
                n += self.num_experts * 3 * d * self.moe_d_ff
                if self.num_shared_experts:
                    n += 3 * d * self.shared_d_ff
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.num_experts:
            return self.n_params()
        full = self.n_params()
        routed_all = sum(1 for k in self.layer_kinds() if k.mlp == "moe") * \
            self.num_experts * 3 * self.d_model * self.moe_d_ff
        routed_active = routed_all * self.top_k / self.num_experts
        return int(full - routed_all + routed_active)
