"""The FLOP and byte counters: a hand count at one small shape, the
counters against `torch.utils.flop_counter` on the reference, and the warp
kernels' bytes against their bounds in PERF.md's kernel table."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, reference

SMALL = dict(pose_type="separate", frame_ids=[0, -1, 1], scales=[0, 1, 2, 3],
             height=64, width=96)


def test_resnet18_trunk_by_hand():
    # ResNet-18 on one 3-channel 64x64 image: stem 32x32, stages at 16, 8, 4, 2
    hand = (2 * 64 * 3 * 49 * 32 * 32
            + 4 * 2 * 64 * 64 * 9 * 16 * 16
            + 2 * 128 * 64 * 9 * 64 + 3 * 2 * 128 * 128 * 9 * 64 + 2 * 128 * 64 * 64
            + 2 * 256 * 128 * 9 * 16 + 3 * 2 * 256 * 256 * 9 * 16 + 2 * 256 * 128 * 16
            + 2 * 512 * 256 * 9 * 4 + 3 * 2 * 512 * 512 * 9 * 4 + 2 * 512 * 256 * 4)
    assert counts.flops(counts.resnet_convs(18, 3, 64, 64)) == hand


def test_pose_decoder_by_hand():
    # a 2048-channel 2x3 level: squeeze 1x1 to 256, two 3x3, 1x1 to 12
    hand = 6 * 2 * (2048 * 256 + 256 * 256 * 9 * 2 + 256 * 12)
    assert counts.flops(counts.pose_decoder_convs(50, 64, 96)) == hand


@pytest.mark.parametrize("num_layers", [18, 50])
def test_forward_matches_flop_counter(num_layers, few_threads):
    cfg = dict(SMALL, num_layers=num_layers)
    model = reference.build(cfg)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model.decoder(model.encoder(torch.rand(2, 3, 64, 96)))
    assert fc.get_total_flops() == counts.depth_forward_flops(cfg, 2)


@pytest.mark.parametrize("num_layers", [18, 50])
def test_train_step_matches_flop_counter(num_layers, few_threads):
    """Forward and both backward products of the depth and pose networks,
    the images taking no gradient."""
    cfg = dict(SMALL, num_layers=num_layers)
    model = reference.build(cfg)
    with FlopCounterMode(display=False) as fc:
        total = sum(d.sum() for d in model.decoder(model.encoder(torch.rand(2, 3, 64, 96))).values())
        for _ in cfg["frame_ids"][1:]:
            axisangle, translation = model.pose_decoder(model.pose_encoder(torch.rand(2, 6, 64, 96)))
            total = total + axisangle.sum() + translation.sum()
        total.backward()
    assert fc.get_total_flops() == counts.train_step_flops(cfg, 2)


def test_headline_counts():
    cfg = dict(SMALL, num_layers=18, height=192, width=640)
    assert counts.train_step_flops(cfg, 12) == 1_246_168_350_720


def test_warp_bytes_match_the_kernel_bounds():
    """640x192 b12: K1 moves 82.6 MB (24.65 us at 3.35 TB/s) and K1-bwd
    76.7 MB (22.89 us), 8 of each a step (PERF.md's kernel table)."""
    pixels = 12 * 192 * 640
    assert round(pixels * counts.K1_BYTES_PER_PX / 3.35e12 * 1e6, 2) == 24.65
    assert round(pixels * counts.K1_BWD_BYTES_PER_PX / 3.35e12 * 1e6, 2) == 22.89
    cfg = dict(SMALL, num_layers=18, height=192, width=640)
    assert counts.warp_train_bytes(cfg, 12) == 8 * pixels * (56 + 52)
