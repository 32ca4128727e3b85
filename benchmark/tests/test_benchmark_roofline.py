"""The yardstick's counts: K1's bytes and the model's FLOPs."""

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark import roofline
from benchmark.reference import model as M


def test_k1_bytes_at_the_flagship_shape():
    shape = (8, 100, 224, 224, 3)
    # bf16 mixup blend in, bf16 out: 2 + 2 bytes a value
    assert roofline.k1_frame_bytes(shape, 2) == 481_689_600
    # and the (8, 16) fp32 parameters, read once
    assert roofline.k1_bytes(shape, 2) == 481_689_600 + 512
    assert abs(roofline.k1_least_s(shape, 2) * 1e3 - 0.14379) < 1e-4


def test_conv_flops_by_hand():
    # the stem: 3 -> 32 channels, 3x3, stride 2, 224 -> 112, one frame:
    # 2 * 32 * 112 * 112 * 3 * 3 * 3 = 21,676,032
    assert roofline.conv_flops(1, 3, 32, 3, 3, 112, 112) == 21_676_032
    # a grouped conv counts its group's input channels only
    assert roofline.conv_flops(2, 24, 24, 3, 3, 8, 8, groups=3) == 2 * 2 * 24 * 64 * 8 * 9


def test_conv_flops_agree_with_the_counter():
    x = torch.empty(4, 16, 20, 20, device="meta")
    w = torch.empty(32, 4, 3, 3, device="meta")
    with FlopCounterMode(display=False) as counter:
        F.conv2d(x, w, stride=2, padding=1, groups=4)
    assert counter.get_total_flops() == roofline.conv_flops(4, 16, 32, 3, 3, 10, 10, groups=4)


def test_forward_flops_scale_with_frames_and_pixels():
    spec = M.Spec("rny002", 8, 2, 7, 4.0, 4, 2)
    one = roofline.forward_flops(spec, 8, 64, 64)
    assert roofline.forward_flops(spec, 16, 64, 64) == 2 * one
    # the trunk dominates and grows with the pixels
    assert roofline.forward_flops(spec, 8, 128, 128) > 3 * one


def test_forward_flops_of_the_flagship_frame():
    spec = M.Spec("rny002", 100, 2, 7, 4.0, 4, 2)
    per_frame = roofline.forward_flops(spec, 100, 224, 224) / 100
    # RegNetY-200MF is 0.2 GMACs at 224; the shift, the SGP and the heads add a little
    assert 0.40e9 < per_frame < 0.43e9
