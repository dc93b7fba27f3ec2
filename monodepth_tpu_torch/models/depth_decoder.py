"""Skip-connected U-Net depth decoder, NCHW, official Monodepth2 layout.

Counterpart of `monodepth_tpu.models.depth_decoder` (reference:
model_layer/depth_decoder.py:54-112): 5 up-stages with channels
[16, 32, 64, 128, 256], nearest 2x upsampling, encoder skip
concatenation, reflection-padded 3x3 convs + ELU, and sigmoid disparity
heads in f32 at the requested scales. The convs sit in one ModuleList,
`decoder.{idx}`, in the order [upconv_4_0, upconv_4_1, ..., upconv_0_1,
dispconv_s for s in scales], as in the official `depth.pth`.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from monodepth_tpu_torch.parallel import rows

NUM_CH_DEC = (16, 32, 64, 128, 256)


def reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """Reflection pad of 1 on H and W of NCHW, as concatenated slices. A
    side of length 1 repeats its one element, as numpy's and jax's reflect
    pad do: the deepest level is 1 pixel high at 32-pixel-high inputs.

    Not `F.pad(mode="reflect")`: its CUDA backward adds with atomics, in an
    order that changes from run to run, so two bf16 train steps from one
    state gave encoder gradients 6e-3 apart (rel-L2, H100). The backward
    of slices and a concatenation is deterministic.

    On row pieces (`parallel.rows`) the H pad takes the neighbours' rows
    and reflects at the image's edges."""
    x = rows.reflect_rows(x, 2)
    n = x.shape[3]
    lo = x.narrow(3, 1, 1) if n > 1 else x
    hi = x.narrow(3, n - 2, 1) if n > 1 else x
    return torch.cat([lo, x, hi], 3)


class Conv3x3(nn.Module):
    """Reflection-pad(1) + 3x3 conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(int(cin), int(cout), 3)

    def forward(self, x):
        return self.conv(reflect_pad1(x))


class ConvBlock(nn.Module):
    """Conv3x3 + ELU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv3x3(cin, cout)
        self.nonlin = nn.ELU(inplace=True)

    def forward(self, x):
        return self.nonlin(self.conv(x))


class DepthDecoder(nn.Module):
    """Encoder pyramid (NCHW) -> {scale: sigmoid disparity [B, 1, H/2^s, W/2^s]},
    at least float32 (the heads leave any autocast dtype; an f64 model
    stays f64)."""

    def __init__(self, num_ch_enc: Sequence[int],
                 scales: Tuple[int, ...] = (0, 1, 2, 3),
                 num_output_channels: int = 1, use_skips: bool = True):
        super().__init__()
        self.scales = tuple(scales)
        self.use_skips = use_skips
        convs = []
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else NUM_CH_DEC[i + 1]
            convs.append(ConvBlock(cin, NUM_CH_DEC[i]))
            cin = NUM_CH_DEC[i]
            if use_skips and i > 0:
                cin += num_ch_enc[i - 1]
            convs.append(ConvBlock(cin, NUM_CH_DEC[i]))
        for s in self.scales:
            convs.append(Conv3x3(NUM_CH_DEC[s], num_output_channels))
        self.decoder = nn.ModuleList(convs)

    def forward(self, features) -> Dict[int, torch.Tensor]:
        # level i is H/2^i high: row pieces or whole as the encoder ran it
        # (`parallel.rows`); the nearest upsample stays on a rank's rows,
        # and a whole level feeding a sharded one is split first
        levels = rows.resnet_levels()
        outputs = {}
        x = features[-1]
        for n, i in enumerate(range(4, -1, -1)):
            with rows.level(levels[i + 1]):
                x = self.decoder[2 * n](x)
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = rows.relevel(x, levels[i + 1], levels[i])
            if self.use_skips and i > 0:
                x = torch.cat([x, features[i - 1].to(x.dtype)], 1)
            with rows.level(levels[i]):
                x = self.decoder[2 * n + 1](x)
                if i in self.scales:
                    head = self.decoder[10 + self.scales.index(i)]
                    y = head(x)
                    outputs[i] = torch.sigmoid(
                        y.to(torch.promote_types(torch.float32, y.dtype)))
        return outputs
