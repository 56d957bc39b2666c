"""The frozen step FLOPs equal the port's cost model for both
configurations today, and the kernel costs count what they say."""
import json

import pytest

from conftest import ROOT
from perfbench import costs
from repro_torch.configs import ShapeCell
from repro_torch.configs.base import ModelConfig
from repro_torch.roofline import costmodel

CONFIGS = ["qwen25-05b", "glm4-9b"]


def port(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())["port"]


@pytest.mark.parametrize("name", CONFIGS)
def test_step_flops_is_the_decode_rule_per_position(name):
    cfg = port(name)
    b, s = 16, 1_000
    want = costmodel.cell_costs(ModelConfig(**cfg),
                                ShapeCell("t", s, b, "decode"), False).flops
    assert costs.step_flops(cfg, b, b * s, b) == pytest.approx(want)


def test_published_sizes():
    q, g = port("qwen25-05b"), port("glm4-9b")
    lin = sum(k * n for k, n in costs.linear_dims(q)) * q["num_layers"]
    assert lin == 357_826_560
    glin = sum(k * n for k, n in costs.linear_dims(g)) * g["num_layers"]
    assert glin == 8_157_921_280


def test_kernel_costs():
    f, b = costs.awq_matmul_cost(4096, 896, 4864, 64, 2, 2)
    assert f == 2 * 4096 * 896 * 4864
    assert b == 4096 * 896 * 2 + 896 * 4864 / 2 + 14 * 4864 * 5 + 896 * 4 \
        + 4096 * 4864 * 2
    f3, b3 = costs.awq_gateup_cost(4096, 896, 4864, 64, 2, 2)
    assert f3 == 2 * f and b3 > b
    # two rows: one at positions 0-15 (16 keys), one padding
    f2, b2 = costs.paged_attention_cost(14, 2, 64, 16, 8, [16, 0],
                                        sum(range(1, 17)))
    assert f2 == 4 * 14 * 64 * 136
    assert b2 == 2 * (2 * 16 * 14 * 64 * 4) + 16 * 2 * 2 * 68 + 2 * 8 * 4 \
        + 2 * 2 * 16 * 4
    assert costs.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    assert costs.peaks("cpu") is None
