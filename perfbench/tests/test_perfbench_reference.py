"""The plain reference agrees with the port's plain (CPU) path at a tiny
size: its int4 rounding, int8 KV storage and RoPE rule for rule, and its
logits within the bf16 activations' rounding of the port's chunk step."""
import numpy as np
import pytest
import torch

from conftest import TINY_PORT
from perfbench.models import dense_gqa as fam
from perfbench.reference.dense_gqa import Reference, int8_kv, rope, rtn_int4
from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import dequantize_packed
from repro_torch.core.pipeline import quantize_params
from repro_torch.models import attention, layers
from repro_torch.models.model import Model

QUANT = {"method": "rtn", "bits": 4, "group_size": 64, "kv": "int8"}


@pytest.mark.parametrize("tied", [True, False])
def test_rtn_copy_matches_the_port_code_for_code(tied):
    cfg = dict(TINY_PORT, tie_embeddings=tied)
    p = fam.layer_floats(cfg, 2**31 + 3, 1, "cpu")
    packed = quantize_params(fam.port_layer(p))[0]
    for name, node in (("wq", packed["attn"]["wq"]),
                       ("down", packed["mlp"]["down"])):
        assert torch.equal(dequantize_packed(node), rtn_int4(p[name], 64))


def test_int8_kv_and_rope_match_the_port():
    x = torch.randn(5, 3, 64, generator=torch.Generator().manual_seed(1))
    q, s = attention._kv_quantize(x)
    assert torch.equal(int8_kv(x), attention._kv_dequant(q, s, torch.float32))
    pos = torch.arange(5)
    cos, sin = layers.rope_cos_sin(pos, 32, 10000.0)
    want = layers.apply_rope(x, cos, sin, 32)
    assert torch.allclose(rope(x, pos, 32, 10000.0), want, atol=1e-6)


def _port_logits(cfg, seed, toks):
    """All positions' logits of the port's chunk step over int8 pages, the
    whole sequence as one row."""
    g = fam.global_floats(cfg, seed, "cpu")
    tree = fam.port_tree(g, [quantize_params(fam.port_layer(
        fam.layer_floats(cfg, seed, i, "cpu")))[0]
        for i in range(cfg["num_layers"])])
    model = Model(ModelConfig(**cfg))
    n = len(toks)
    pages = -(-n // 16)
    cache = model.init_paged_cache(pages + 1, 16, kv_quant="int8",
                                   device="cpu")
    logits, _ = model.chunk_step(
        tree, cache, torch.as_tensor(toks, dtype=torch.int32)[None],
        torch.arange(n, dtype=torch.int32)[None],
        torch.zeros(1, dtype=torch.int32),
        torch.arange(1, pages + 1, dtype=torch.int32)[None], num_logits=n)
    return logits[0]


@pytest.mark.parametrize("tied", [True, False])
def test_reference_agrees_with_the_port(tied):
    cfg = dict(TINY_PORT, tie_embeddings=tied)
    seed = 2**31 + 17
    toks = np.random.default_rng(0).integers(0, cfg["vocab_size"], 40)
    port = _port_logits(cfg, seed, toks)
    seq = torch.as_tensor(toks, dtype=torch.int64)
    ref = Reference(cfg, QUANT, seed, "cpu").logits([seq], [0])[0]
    low = Reference(cfg, QUANT, seed, "cpu", act="fp8").logits([seq], [0])[0]
    scale = ref.abs().max()
    err = float((port - ref).abs().max() / scale)
    assert err < 0.03
    # the control, a precision below the program's, leaves it further
    assert float((low - ref).abs().max() / scale) > 2 * err
