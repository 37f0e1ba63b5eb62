"""The yardstick's counts against counts done by hand at a tiny shape."""

import pytest
import torch

from portbench.lib import counts
from portbench.reference import model as ref_model


def test_bound_takes_the_larger_time():
    assert counts.bound_s(3.35e12, 0, "float32") == pytest.approx(1.0)
    assert counts.bound_s(0, 989e12, "bfloat16") == pytest.approx(1.0)
    assert counts.bound_s(3.35e12, 2 * 67e12, "float32") == \
        pytest.approx(2.0)


def test_taps_and_texels_by_hand():
    # identity rotation, a shift of half a pixel right: every reference
    # pixel taps x0 = x and x0 + 1 of row y (the second tap weighs 0 in
    # the row below, which is still a tap); the last column's right taps
    # fall off the image
    h, w = 3, 4
    rot = torch.eye(3).reshape(1, 1, 3, 3)
    trans = torch.tensor([[[0.5, 0.0, 0.0]]])
    depth = torch.ones(1, 1, h, w)
    n_taps, texels = counts.taps(rot, trans, depth, h, w)
    # x taps: x and x+1 (x+1 off for the last column); y taps: y and y+1
    # (y+1 off on the last row)
    assert n_taps == (2 * w - 1) * (2 * h - 1)
    assert texels == h * w


def test_kernel_work_by_hand():
    b, f = counts.k2_work(1, 2, 3, 16, "bfloat16")
    assert f == 108 * 16 * 16 * 6
    assert b == 3 * 6 * 16 * 2 + (9 * 32 * 48 + 48) * 4
    b, f = counts.k4_work(10, (3, 8, 8), "float32")
    assert f == 18 * 10 * (24 + 64)
    assert b == 10 * 11 * 4 + (9 * 24 + 8 + 9 * 64 + 8) * 4
    b, f = counts.k1_work(1, 2, 4, 3, 5, 8, 7, "float32", False)
    assert f == 2 * 4 * 15 * (10 * 8 + 16)
    assert b == (15 * 8 + 7 * 8 + 120) * 4 + 4 * 4 + 2 * 12 * 4
    model = dict(hdim=[48, 32, 16], gru_iters=[3, 3, 3],
                 feature_channels=[8, 16, 32, 64],
                 context_channels=[4, 8, 16, 32])
    assert len(counts.k2_launches(model, 1, 64, 96, "float32")) == 9
    k4 = counts.k4_launches(model, 2, 3, 64, 96, "float32")
    assert len(k4) == 8
    assert k4[0][1] == 18 * 6 * 64 * 96 * (3 * 8 + 8 * 8)


def test_reference_flops_by_hand():
    c = ref_model.Counter()
    net = ref_model.Reference({"a.weight": torch.ones(4, 3, 3, 3),
                               "b.weight": torch.ones(3, 2, 3, 3, 3)},
                              {"ndepths": [1], "cost_num": 1,
                               "gru_iters": [1], "hdim": [1],
                               "interval_ratio": [1]}, counter=c)
    net.conv(torch.ones(1, 5, 6, 3), "a", padding=1)
    assert c.fwd == 2 * 5 * 6 * 4 * 3 * 9
    c.fwd = 0
    x = torch.ones(1, 2, 2, 2, 3, requires_grad=True)
    net.conv(x, "b", stride=2, padding=1, transpose=True, output_padding=1)
    assert c.fwd == 2 * 8 * 3 * 2 * 27
    assert c.bwd == 2 * 8 * 3 * 2 * 27       # the input's gradient only
