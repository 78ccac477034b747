"""The analytic Monodepth2 operation count against PyTorch's own count of
the plain reference's convolutions, at small sizes (odd ones included)."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.references import monodepth2 as ref


@pytest.mark.parametrize("n,h,w", [(1, 64, 96), (2, 48, 160), (1, 70, 90)])
def test_forward_counts_match_the_flop_counter(n, h, w):
    torch.manual_seed(0)
    model = ref.Monodepth2()
    img = torch.rand(n, h, w, 3)
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            model.depth(img, False)
        assert fc.get_total_flops() == ref.depth_forward_flops(n, h, w)
        with FlopCounterMode(display=False) as fc:
            model.pose(img, img, False)
        assert fc.get_total_flops() == ref.pose_forward_flops(n, h, w)


def test_train_step_count():
    assert ref.train_step_flops(12, 192, 640) == 3 * (
        ref.depth_forward_flops(12, 192, 640) + 2 * ref.pose_forward_flops(12, 192, 640))
    assert 1.2e12 < ref.train_step_flops(12, 192, 640) < 1.4e12
