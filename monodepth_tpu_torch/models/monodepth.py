"""Monodepth wiring: depth net + pose net under one module.

Counterpart of `monodepth_tpu.models.monodepth.Monodepth` (reference:
model_tool/loader.py:70-96, model_tool/processor.py:33-136), with its
three pose wirings:

- ``separate``: a dedicated pose ResNet encoder over channel-stacked
  frames + `PoseDecoder(1, 2)`;
- ``shared``: the depth encoder's features reused for pose; every frame,
  "s" included, goes through one encoder pass stacked on the batch axis
  and is split after it (so train-mode batch norm normalizes over B·F
  images), and `PoseDecoder(num_pose_frames)` reads the pyramids;
- ``posecnn``: `PoseCNN(num_pose_frames)` on channel-stacked raw frames;

and ``pose_frames="all"``: one joint pass over every temporal frame
(processor.py:116-135) instead of one pass per pair. Pose pairs follow
the reference order: a past frame f<0 pairs as [f, 0] and its transform
is inverted at warp time, a future frame f>0 pairs as [0, f]; in "all"
mode nothing is inverted (`invert_for_frame`). The stereo frame "s" is
never a pose source: its transform comes with the batch.

Public methods take and return NHWC (frames [B, F, H, W, 3], disparities
[B, h, w, 1]); the submodules run NCHW. state_dict keys: `encoder.*`
(torchvision), `decoder.decoder.{idx}.*` (official Monodepth2),
`pose_decoder.net.{idx}.*` (`pose.pth`, or a PoseCNN checkpoint with
`pose_decoder.pose_conv.*`), and for ``separate`` `pose_encoder.*`
(torchvision, conv1 over 3·num_pose_frames channels). `remat` recomputes
the encoders' residual blocks in the backward (`ResNetEncoder`), as the
JAX `Monodepth` hands it to both encoders.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import torch
from torch import nn

from monodepth_tpu_torch.models.depth_decoder import DepthDecoder
from monodepth_tpu_torch.models.pose_decoder import PoseCNN, PoseDecoder
from monodepth_tpu_torch.models.resnet import ResNetEncoder, num_ch_enc

FrameId = Union[int, str]

# the top-level modules, in state_dict order: the `separate` wiring has all
# four, `shared` and `posecnn` no `pose_encoder` (`model_modules`)
MODULES = ("encoder", "decoder", "pose_encoder", "pose_decoder")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Monodepth(nn.Module):
    def __init__(self, num_layers: int = 18,
                 scales: Tuple[int, ...] = (0, 1, 2, 3),
                 frame_ids: Tuple[FrameId, ...] = (0, -1, 1),
                 pose_type: str = "separate",
                 pose_frames: Union[int, str] = 2,
                 remat: bool = False):
        super().__init__()
        self.scales = tuple(scales)
        self.frame_ids = tuple(frame_ids)
        self.pose_type = pose_type
        self.pose_frames = pose_frames
        ch = num_ch_enc(num_layers)
        self.encoder = ResNetEncoder(num_layers, 1, remat)
        self.decoder = DepthDecoder(ch, self.scales)
        n = self.num_pose_frames
        if pose_type == "posecnn":
            self.pose_decoder = PoseCNN(n)
        elif pose_type == "shared":
            self.pose_decoder = PoseDecoder(ch, n)
        elif pose_type == "separate":
            self.pose_encoder = ResNetEncoder(num_layers, n, remat)
            # the reference always predicts 2 frames here (loader.py:85-86)
            self.pose_decoder = PoseDecoder(ch, 1, 2)
        else:
            raise ValueError(f"unknown pose_type {pose_type!r}")

    @property
    def temporal_ids(self) -> Tuple[int, ...]:
        return tuple(f for f in self.frame_ids if f != "s")

    @property
    def num_pose_frames(self) -> int:
        return len(self.temporal_ids) if self.pose_frames == "all" else 2

    def invert_for_frame(self, frame_id: int) -> bool:
        """Whether the predicted transform is inverted at warp time. In
        "all" mode nothing is inverted: the joint pass predicts each
        source's motion directly (processor.py:131-135). posecnn + "all"
        follows the JAX package's documented deviation: the per-frame
        predictions, not inverted (the reference warps every frame with
        slot 0 there, processor.py:153-157)."""
        return self.pose_frames != "all" and frame_id < 0

    def depth(self, image: torch.Tensor) -> Dict[int, torch.Tensor]:
        """[B, H, W, 3] -> {scale: [B, H/2^s, W/2^s, 1]} (eval forward)."""
        disps = self.decoder(self.encoder(_nchw(image)))
        return {s: _nhwc(d) for s, d in disps.items()}

    def _frame(self, frames, frame_id: FrameId) -> torch.Tensor:
        return _nchw(frames[:, self.frame_ids.index(frame_id)])

    def _stacked(self, frames, ids) -> torch.Tensor:
        return torch.cat([self._frame(frames, f) for f in ids], 1)

    def forward(self, frames: torch.Tensor):
        """frames [B, F, H, W, 3] -> (disps {scale: [B, h, w, 1]},
        poses {frame_id: (axisangle [B, 3], translation [B, 3])})."""
        features = None
        if self.pose_type == "shared":
            # every frame through one encoder pass, split after it
            # (processor.py:41-49)
            B, F = frames.shape[:2]
            feats = self.encoder(_nchw(frames.transpose(0, 1).reshape(
                F * B, *frames.shape[2:])))
            features = {fid: [f.reshape(F, B, *f.shape[1:])[i] for f in feats]
                        for i, fid in enumerate(self.frame_ids)}
            disps = self.decoder(features[0])
        else:
            disps = self.decoder(self.encoder(self._frame(frames, 0)))
        poses = self._poses(frames, features)
        return {s: _nhwc(d) for s, d in disps.items()}, poses

    def _pose(self, frames, features, ids):
        if self.pose_type == "posecnn":
            return self.pose_decoder(self._stacked(frames, ids))
        if self.pose_type == "shared":
            return self.pose_decoder([features[f] for f in ids])
        return self.pose_decoder([self.pose_encoder(self._stacked(frames, ids))])

    def _poses(self, frames, features):
        sources = [f for f in self.frame_ids[1:] if f != "s"]
        if self.pose_frames == "all":  # one joint pass (processor.py:116-135)
            aa, t = self._pose(frames, features, self.temporal_ids)
            return {fid: (aa[:, i, 0], t[:, i, 0]) for i, fid in enumerate(sources)}
        poses = {}
        for fid in sources:
            aa, t = self._pose(frames, features, (fid, 0) if fid < 0 else (0, fid))
            poses[fid] = (aa[:, 0, 0], t[:, 0, 0])
        return poses

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers: encoder convs
        (`encoder`, `pose_encoder`) He-normal over fan-out, every other
        conv (the decoders, PoseCNN) LeCun truncated-normal over fan-in
        with zero bias, batch norm at identity."""
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


def model_modules(model: Monodepth) -> Tuple[str, ...]:
    """The names in `MODULES` that `model`'s wiring has, in that order."""
    return tuple(m for m in MODULES if hasattr(model, m))


def _truncated_normal(shape, std: float, generator: torch.Generator):
    """N(0, 1) truncated to [-2, 2], rescaled to standard deviation `std`
    (flax's `lecun_normal`), by inverting the CDF of a uniform draw."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(shape, generator=generator)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return z * (std / 0.87962566103423978)
