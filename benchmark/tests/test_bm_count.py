"""The benchmark's count of the work, on the meta device."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import count, spec, weights
from benchmark.reference import mica, unet
from benchmark.reference.ops import Arith


def _spec(config):
    return spec.reference_spec(
        spec.load_json(spec.HERE / "configs" / f"{config}.json"),
        spec.load_json(spec.HERE / "traffic" / "serve_b8.json"))


@pytest.mark.parametrize("config,res,gflop", [("sr3_16_128", 128, 89.00),
                                              ("sr3_8_32", 32, 5.56)])
def test_unet_flops(config, res, gflop):
    s = _spec(config)
    for quant in (False, True):
        got = sum(count.unet_flops(s, res, quant).values()) / 1e9
        assert round(got, 2) == gflop
    q = count.unet_flops(s, res, True)
    assert q["int8"] > 0.9 * (q["int8"] + q["bf16"])


def test_unet_flops_agree_with_flop_counter():
    s = _spec("sr3_8_32")
    p = {n: torch.empty(sh, device="meta")
         for n, sh, _ in weights.specs(s)["unet"]}
    x = torch.empty(1, 6, 32, 32, device="meta")
    with FlopCounterMode(display=False) as fc:
        unet.unet_forward(p, s["unet"], s["image_size"], x,
                          torch.empty(1, 1, device="meta"), Arith())
    assert fc.get_total_flops() == pytest.approx(
        sum(count.unet_flops(s, 32, False).values()), rel=1e-9)


def test_arcface_flops():
    s = _spec("sr3_16_128")
    p = {n: torch.empty(sh, device="meta")
         for n, sh, _ in weights.specs(s)["arcface"]}
    with FlopCounterMode(display=False) as fc:
        mica.arcface_forward(p, s["mica"]["arcface_layers"],
                             torch.empty(1, 3, 112, 112, device="meta"),
                             Arith())
    assert round(fc.get_total_flops() / 1e9, 2) == 24.18
    t = count.mica_flops(s)
    # the dense head, the mapping network and the FLAME blend in fp32
    assert round((t["bf16"] + t["fp32"]) / 1e9, 2) == 24.19


def test_least_time_and_bound():
    s = _spec("sr3_16_128")
    per_face = count.serve_flops_per_face(s)
    assert per_face["int8"] == pytest.approx(25 * 83.6512e9, rel=1e-5)
    assert 1.1e-3 < count.least_seconds(per_face) < 1.3e-3
    assert count.bound(3.35e9, 1.0, "bf16") == (1.0, "bytes")
    assert count.bound(0.0, 989e9, "bf16") == (1.0, "operations")


def test_parameter_counts():
    s = _spec("sr3_16_128")
    n = {k: sum(torch.Size(sh).numel() for _, sh, _ in v)
         for k, v in weights.specs(s).items()}
    assert round(n["unet"] / 1e6, 1) == 92.6
    assert round(n["arcface"] / 1e6, 1) == 65.2
