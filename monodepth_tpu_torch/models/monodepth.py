"""Monodepth wiring: depth net + pose net under one module, `separate` pose.

Counterpart of `monodepth_tpu.models.monodepth.Monodepth` (reference:
model_tool/loader.py:70-96, model_tool/processor.py:33-136) for the
``separate`` wiring: a dedicated 2-image pose ResNet encoder + PoseDecoder.
Pose pairs follow the reference order: a past frame f<0 pairs as [f, 0]
and its transform is inverted at warp time, a future frame f>0 pairs as
[0, f]. The ``shared`` and ``posecnn`` wirings and ``pose_frames="all"``
come with slice 6 of the port (ROADMAP.md).

Public methods take and return NHWC (frames [B, F, H, W, 3], disparities
[B, h, w, 1]); the submodules run NCHW. state_dict keys: `encoder.*`
(torchvision), `decoder.decoder.{idx}.*` and `pose_decoder.net.{idx}.*`
(official Monodepth2), `pose_encoder.*` (torchvision, 6-channel conv1).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import torch
from torch import nn

from monodepth_tpu_torch.models.depth_decoder import DepthDecoder
from monodepth_tpu_torch.models.pose_decoder import PoseDecoder
from monodepth_tpu_torch.models.resnet import ResNetEncoder, num_ch_enc

FrameId = Union[int, str]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Monodepth(nn.Module):
    def __init__(self, num_layers: int = 18,
                 scales: Tuple[int, ...] = (0, 1, 2, 3),
                 frame_ids: Tuple[FrameId, ...] = (0, -1, 1),
                 pose_type: str = "separate",
                 pose_frames: Union[int, str] = 2):
        super().__init__()
        if pose_type != "separate":
            raise NotImplementedError(
                f"pose_type {pose_type!r} comes with slice 6 of the port "
                "(other wirings); this slice has 'separate'")
        if pose_frames != 2:
            raise NotImplementedError(
                "pose_frames='all' comes with slice 6 of the port")
        if "s" in frame_ids:
            raise NotImplementedError(
                "the stereo frame comes with slice 6 of the port")
        self.scales = tuple(scales)
        self.frame_ids = tuple(frame_ids)
        self.pose_frames = pose_frames
        ch = num_ch_enc(num_layers)
        self.encoder = ResNetEncoder(num_layers, 1)
        self.decoder = DepthDecoder(ch, self.scales)
        self.pose_encoder = ResNetEncoder(num_layers, 2)
        # the reference always predicts 2 frames here (loader.py:85-86)
        self.pose_decoder = PoseDecoder(ch, 1, 2)

    def invert_for_frame(self, frame_id: int) -> bool:
        """Whether the predicted transform is inverted at warp time."""
        return self.pose_frames != "all" and frame_id < 0

    def depth(self, image: torch.Tensor) -> Dict[int, torch.Tensor]:
        """[B, H, W, 3] -> {scale: [B, H/2^s, W/2^s, 1]} (eval forward)."""
        disps = self.decoder(self.encoder(_nchw(image)))
        return {s: _nhwc(d) for s, d in disps.items()}

    def _frame(self, frames, frame_id: FrameId) -> torch.Tensor:
        return _nchw(frames[:, self.frame_ids.index(frame_id)])

    def forward(self, frames: torch.Tensor):
        """frames [B, F, H, W, 3] -> (disps {scale: [B, h, w, 1]},
        poses {frame_id: (axisangle [B, 3], translation [B, 3])})."""
        disps = self.decoder(self.encoder(self._frame(frames, 0)))
        poses = {}
        for fid in self.frame_ids[1:]:
            pair = (fid, 0) if fid < 0 else (0, fid)
            x = torch.cat([self._frame(frames, p) for p in pair], 1)
            aa, t = self.pose_decoder([self.pose_encoder(x)])
            poses[fid] = (aa[:, 0, 0], t[:, 0, 0])
        return {s: _nhwc(d) for s, d in disps.items()}, poses

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers: encoder convs
        He-normal over fan-out, decoder convs LeCun truncated-normal over
        fan-in with zero bias, batch norm at identity."""
        for name, module in self.named_modules():
            if isinstance(module, nn.Conv2d):
                fan_in = module.weight[0].numel()
                fan_out = module.weight.shape[0] * module.weight[0, 0].numel()
                if name.split(".")[0] in ("encoder", "pose_encoder"):
                    module.weight.copy_(math.sqrt(2.0 / fan_out) * torch.randn(
                        module.weight.shape, generator=generator))
                else:
                    module.weight.copy_(_truncated_normal(
                        module.weight.shape, math.sqrt(1.0 / fan_in), generator))
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()


def _truncated_normal(shape, std: float, generator: torch.Generator):
    """N(0, 1) truncated to [-2, 2], rescaled to standard deviation `std`
    (flax's `lecun_normal`), by inverting the CDF of a uniform draw."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(shape, generator=generator)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return z * (std / 0.87962566103423978)
