"""The placed one-shot step of the MLA + MoE, SSD, hybrid and encoder
families, held against the JAX package by the harness and the rules of
`test_torch_placed_step.py` (f32 activations, compute and caches; B 4,
caches of 64 and 12; 3 greedy decode steps; (1 × 2), (1 × 4) and
(2 × 4) meshes of ``"cpu"`` devices): logits within 2e-2 of the
reference's unplaced step and 1e-4 of the port's, greedy tokens equal
on clear rows, every cache piece the rule's shard shape, and the joined
cache byte for byte the unplaced step's over the same stripes.

  * deepseek-v2-lite (MLA + MoE, a dense first layer): the latents
    ``ckv`` / ``kpe`` striped along S (64) or whole (12); 2 heads, so at
    ``model`` 4 ``kv_up``'s stripes cut heads and the absorbed decode
    joins it on the first shard; the routed experts' decode at M = B,
    dropless (capacity = tokens) as the unplaced layer's;
  * qwen2-moe (attention + MoE with shared experts);
  * mamba2 (SSD, 4 heads): the conv caches over channels, the state over
    heads (1 or 2 a shard), B's and C's conv steps on their channel
    stripes;
  * hymba (attention ∥ SSD; windowed rings of 32 between global layers;
    1 kv head);
  * for both SSM families the first block's cache byte for byte, a later
    block's within 1e-5 of each leaf's largest magnitude: its input has
    passed the gated norm's split sum of squares (`layers.
    rmsnorm_split`, the shards' sums added in shard order) and, in the
    prefill, the train-mode sharded mixer's per-shard ``softplus`` /
    ``exp`` over one or two heads, which PyTorch's CPU kernels round
    otherwise than over all four (`ssm.ssm_mixer_tp`);
  * hubert (the encoder: a prefill of 40 or 8 frames, its cache written
    and every frame's logits returned, no decode step).
"""
import pytest

from test_torch_placed_step import (LONG, MESHES, SHORT,  # noqa: F401
                                    _f32_compute, _one_thread, make_case,
                                    run_case)

CASES = {"deepseek": ("deepseek-v2-lite-16b", {}),
         "deepseek-rtn": ("deepseek-v2-lite-16b", {"quant": True}),
         "qwen2-moe": ("qwen2-moe-a2.7b", {}),
         "mamba2": ("mamba2-130m", {}),
         "hymba": ("hymba-1.5b", {}),
         "hubert": ("hubert-xlarge", {})}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    arch, over = CASES[request.param]
    out = make_case(arch, **over)
    out["key"] = request.param
    return out


@pytest.mark.parametrize("s", [LONG, SHORT], ids=["striped", "short"])
@pytest.mark.parametrize("dims", MESHES, ids=["1x2", "1x4", "2x4"])
def test_placed_step_matches_reference_and_unplaced(case, dims, s):
    kw = {}
    if case["key"] in ("hymba", "mamba2"):
        kw = dict(exact=lambda path: path.startswith("seg_0/0/"), near=1e-5)
    placed = run_case(case, dims, s, **kw)
    first = placed["placed"][0] if dims[0] > 1 else placed["placed"]
    layer = first["seg_0"][0]
    cfg = case["m"].cfg
    n = dims[1]
    if "ssm" in layer:
        state = layer["ssm"]["state"]
        if cfg.ssm_nheads % n == 0:
            assert isinstance(state, list) and state[0].shape[1] == \
                cfg.ssm_nheads // n
        else:
            assert not isinstance(state, list)
    if case["key"].startswith("deepseek"):
        mla = first["seg_0"][0]["mla"]["ckv"]
        assert isinstance(mla, list) == (s == LONG)
