"""The reference: the frozen codec against hand-worked codes, and its
distances on hand-worked rows."""

import math

import pytest
import torch

from portbench.reference import codec
from portbench.reference.exact import Reference


def test_codec_8_bit_by_hand():
    x = torch.tensor([-1.0, -2.0, 1.0, 3.0, 0.0, 0.5, -0.5, 0.00784,
                      0.00785], dtype=torch.float64)
    # (x + 1) / 2 * 255 + 0.5, floored: 0, 0 (clamped), 255, 255 (clamped),
    # 128 (127.5 + .5), 191 (191.25 + .5), 64 (63.75 + .5), 128
    # (128.4996 + .5), 129 (128.5009 + .5)
    assert codec.quantize(x, 8).tolist() == [0, 0, 255, 255, 128, 191, 64,
                                             128, 129]
    assert codec.dequantize(torch.tensor([0, 255, 128]), 8).tolist() == \
        [-1.0, 1.0, 128 / 255 * 2 - 1]


def test_codec_4_bit_by_hand():
    x = torch.tensor([-1.0, 0.0, 0.2, 1.0])
    # (x + 1) / 2 * 15 + 0.5: 0.5, 8.0, 9.5, 15.5 -> 0, 8, 9, 15
    assert codec.quantize(x, 4).tolist() == [0, 8, 9, 15]
    assert codec.dequantize(torch.tensor([15]), 4).tolist() == [1.0]


def test_reference_distances_by_hand():
    rows = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [1.0, 1.0]])
    ref = Reference(rows, bits=8, metric="cosine")
    q = torch.tensor([[1.0, 0.0]], dtype=torch.float64)
    d, r = ref.topk(q, 4, "cpu")
    assert r.tolist() == [[0, 3, 1, 2]]
    # stored: 0 -> code 128 -> 1/255; 1 -> 1; -1 -> -1
    e = 1 / 255
    n = math.sqrt(1 + e * e)
    want = [math.acos(1 / n), 0.25 * math.pi, math.acos(e / n),
            math.acos(-1 / n)]
    assert d[0].tolist() == pytest.approx([w / math.pi for w in want],
                                          abs=1e-12)
    p = ref.pairs(q, torch.tensor([[2, -1]]), "cpu")
    assert p[0, 0].item() == pytest.approx(want[3] / math.pi) and \
        math.isinf(p[0, 1])
    eu = Reference(rows, bits=8, metric="euclidean")
    v = codec.dequantize(torch.tensor([255, 128]), 8)   # row 0 as stored
    assert eu.pairs(q, torch.tensor([[0]]), "cpu")[0, 0].item() == \
        pytest.approx(abs(v[1].item()))
    assert eu.stored([0]).tolist() == [v.tolist()]


def test_controls_lose_precision():
    g = torch.Generator().manual_seed(3)
    rows = torch.randn(500, 32, generator=g)
    rows /= rows.norm(dim=1, keepdim=True)
    q = rows[:8].double()
    ref = Reference(rows, bits=8, metric="cosine")
    for ctl in (Reference(rows, bits=4, metric="cosine"),
                Reference(rows, bits=8, metric="cosine",
                          rounding=torch.bfloat16)):
        d_ref = ref.pairs(q, torch.arange(500).expand(8, 500), "cpu")
        d_ctl = ctl.pairs(q, torch.arange(500).expand(8, 500), "cpu")
        assert (d_ref - d_ctl).abs().max() > 1e-4
