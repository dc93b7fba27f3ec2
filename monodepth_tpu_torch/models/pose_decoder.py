"""Pose regressors, NCHW, official Monodepth2 layout: the feature-pyramid
`PoseDecoder` and the image-space `PoseCNN`.

Counterparts of `monodepth_tpu.models.pose_decoder` (reference:
model_layer/pose_decoder.py:13-98). Both emit (axisangle, translation),
each [B, num_frames_to_predict_for, 1, 3], scaled by 0.01.
`PoseDecoder`'s convs are `net.{0..3}` = [squeeze, pose_0, pose_1,
pose_2], as in the official `pose.pth`; `PoseCNN`'s are `net.{0..6}` and
`pose_conv`, as in a Monodepth2 PoseCNN checkpoint.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn


class PoseDecoder(nn.Module):
    """num_input_features: how many encoder pyramids come in (1 for the
    `separate` wiring on a concatenated pair, num_pose_frames for
    `shared`). num_frames_to_predict_for defaults to num_input_features - 1."""

    def __init__(self, num_ch_enc: Sequence[int], num_input_features: int,
                 num_frames_to_predict_for: int | None = None):
        super().__init__()
        self.num_frames = (num_input_features - 1
                           if num_frames_to_predict_for is None
                           else num_frames_to_predict_for)
        self.net = nn.ModuleList([
            nn.Conv2d(int(num_ch_enc[-1]), 256, 1),
            nn.Conv2d(num_input_features * 256, 256, 3, 1, 1),
            nn.Conv2d(256, 256, 3, 1, 1),
            nn.Conv2d(256, 6 * self.num_frames, 1),
        ])

    def forward(self, input_features) -> Tuple[torch.Tensor, torch.Tensor]:
        # one shared squeeze conv over every pyramid's last level
        out = torch.cat([torch.relu(self.net[0](f[-1]))
                         for f in input_features], 1)
        out = torch.relu(self.net[1](out))
        out = torch.relu(self.net[2](out))
        out = self.net[3](out)
        # global average in at least f32 (an f64 model stays f64)
        out = out.to(torch.promote_types(torch.float32, out.dtype)).mean(dim=(2, 3))
        out = 0.01 * out.reshape(-1, self.num_frames, 1, 6)
        return out[..., :3], out[..., 3:]


class PoseCNN(nn.Module):
    """SfM-Learner-style pose regressor on channel-stacked raw frames
    [B, 3·num_input_frames, H, W]: seven stride-2 convs, each followed by
    a ReLU (the JAX package's documented deviation: the reference forgets
    the ReLU after its first conv, pose_decoder.py:86-89), then a 1x1
    `pose_conv` to 6·(num_input_frames - 1) channels, a global average in
    at least f32 and x0.01."""

    SPECS = ((16, 7), (32, 5), (64, 3), (128, 3), (256, 3), (256, 3), (256, 3))

    def __init__(self, num_input_frames: int):
        super().__init__()
        self.num_frames = num_input_frames - 1
        convs, cin = [], 3 * num_input_frames
        for cout, k in self.SPECS:
            convs.append(nn.Conv2d(cin, cout, k, 2, (k - 1) // 2))
            cin = cout
        self.net = nn.ModuleList(convs)
        self.pose_conv = nn.Conv2d(cin, 6 * self.num_frames, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        for conv in self.net:
            x = torch.relu(conv(x))
        out = self.pose_conv(x)
        out = out.to(torch.promote_types(torch.float32, out.dtype)).mean(dim=(2, 3))
        out = 0.01 * out.reshape(-1, self.num_frames, 1, 6)
        return out[..., :3], out[..., 3:]
