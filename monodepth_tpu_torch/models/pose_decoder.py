"""Feature-pyramid pose regressor, NCHW, official Monodepth2 layout.

Counterpart of `monodepth_tpu.models.pose_decoder.PoseDecoder`
(reference: model_layer/pose_decoder.py:13-58). Emits (axisangle,
translation), each [B, num_frames_to_predict_for, 1, 3], scaled by 0.01.
The convs are `net.{0..3}` = [squeeze, pose_0, pose_1, pose_2], as in
the official `pose.pth`. PoseCNN comes with a later slice.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn


class PoseDecoder(nn.Module):
    """num_input_features: how many encoder pyramids come in (1 for the
    `separate` wiring on a concatenated pair). num_frames_to_predict_for
    defaults to num_input_features - 1."""

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
