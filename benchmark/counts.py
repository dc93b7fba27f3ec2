"""The work a call needs, counted from the published architecture and the
cell's shapes, whatever implements it: the floating-point operations of
the networks' convolutions, and the bytes the warp kernels must move.

A convolution of Cin -> Cout channels with a k x k kernel over an output of
Ho x Wo pixels does 2·Cin·Cout·k²·Ho·Wo operations an image (a multiply
and an add per weight and output pixel). A train step does each forward
product once more for the gradient of its weights and once more for that
of its input, except where the input is the image, which takes no
gradient: 3x, and 2x for each encoder's first convolution. No product is
counted twice for recomputation.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.reference import DECODER_CHANNELS, STAGES

Conv = Tuple[int, int, int, int, int]  # (cin, cout, kernel, out rows, out cols)

K1_BYTES_PER_PX = 8 + 12 + 12 + 12 + 12      # grid, image; out, gx, gy (C = 3, f32)
K1_BWD_BYTES_PER_PX = 8 + 12 + 12 + 12 + 8   # grid, dout, gx, gy; dgrid


def _out(size: int, kernel: int, stride: int) -> int:
    return (size + 2 * ((kernel - 1) // 2) - kernel) // stride + 1


def resnet_convs(num_layers: int, cin: int, height: int, width: int) -> List[Conv]:
    """Every convolution of a torchvision ResNet's trunk, stem first."""
    depths, kind = STAGES[num_layers]
    expansion = 1 if kind == "basic" else 4
    h, w = _out(height, 7, 2), _out(width, 7, 2)
    convs = [(cin, 64, 7, h, w)]
    h, w = _out(h, 3, 2), _out(w, 3, 2)          # max pool
    c = 64
    for stage, (depth, width_) in enumerate(zip(depths, (64, 128, 256, 512)), 1):
        for i in range(depth):
            stride = 2 if stage > 1 and i == 0 else 1
            ho, wo = _out(h, 3, stride), _out(w, 3, stride)
            out = width_ * expansion
            if kind == "basic":
                convs += [(c, width_, 3, ho, wo), (width_, width_, 3, ho, wo)]
            else:
                convs += [(c, width_, 1, h, w), (width_, width_, 3, ho, wo),
                          (width_, out, 1, ho, wo)]
            if i == 0 and (stride != 1 or c != out):
                convs.append((c, out, 1, ho, wo))
            c, h, w = out, ho, wo
    return convs


def encoder_channels(num_layers: int) -> List[int]:
    expansion = 1 if STAGES[num_layers][1] == "basic" else 4
    return [64] + [w * expansion for w in (64, 128, 256, 512)]


def depth_decoder_convs(num_layers: int, scales, height: int, width: int) -> List[Conv]:
    enc = encoder_channels(num_layers)
    level = lambda i: (height >> i, width >> i)  # noqa: E731
    convs = []
    for i in range(4, -1, -1):
        cin = enc[-1] if i == 4 else DECODER_CHANNELS[i + 1]
        convs.append((cin, DECODER_CHANNELS[i], 3, *level(i + 1)))
        cin = DECODER_CHANNELS[i] + (enc[i - 1] if i > 0 else 0)
        convs.append((cin, DECODER_CHANNELS[i], 3, *level(i)))
    convs += [(DECODER_CHANNELS[s], 1, 3, *level(s)) for s in scales]
    return convs


def pose_decoder_convs(num_layers: int, height: int, width: int) -> List[Conv]:
    h, w = height >> 5, width >> 5
    return [(encoder_channels(num_layers)[-1], 256, 1, h, w), (256, 256, 3, h, w),
            (256, 256, 3, h, w), (256, 12, 1, h, w)]


def flops(convs: List[Conv]) -> int:
    return sum(2 * cin * cout * k * k * h * w for cin, cout, k, h, w in convs)


def depth_forward_flops(cfg: dict, batch: int) -> int:
    """The depth network's forward on `batch` images."""
    H, W = cfg["height"], cfg["width"]
    return batch * (flops(resnet_convs(cfg["num_layers"], 3, H, W))
                    + flops(depth_decoder_convs(cfg["num_layers"], cfg["scales"], H, W)))


def _pose_sources(cfg: dict) -> int:
    """The source frames the pose network sees: the stereo frame's
    transform comes with the batch."""
    return len([f for f in cfg["frame_ids"][1:] if f != "s"])


def pose_forward_flops(cfg: dict, batch: int) -> int:
    """The `separate` pose network's forward, one pass a temporal source."""
    H, W = cfg["height"], cfg["width"]
    sources = _pose_sources(cfg)
    return batch * sources * (flops(resnet_convs(cfg["num_layers"], 6, H, W))
                              + flops(pose_decoder_convs(cfg["num_layers"], H, W)))


def train_step_flops(cfg: dict, batch: int) -> int:
    """A train step's forward and backward products of both networks."""
    H, W = cfg["height"], cfg["width"]
    sources = _pose_sources(cfg)
    stems = batch * (flops(resnet_convs(cfg["num_layers"], 3, H, W)[:1])
                     + sources * flops(resnet_convs(cfg["num_layers"], 6, H, W)[:1]))
    return 3 * (depth_forward_flops(cfg, batch) + pose_forward_flops(cfg, batch)) - stems


def warp_train_bytes(cfg: dict, batch: int) -> int:
    """The least bytes a train step's warps move: each warp's train-form
    forward (K1) and its backward to the grid (K1-bwd), at full
    resolution, one per source frame and scale."""
    warps = (len(cfg["frame_ids"]) - 1) * len(cfg["scales"])
    pixels = batch * cfg["height"] * cfg["width"]
    return warps * pixels * (K1_BYTES_PER_PX + K1_BWD_BYTES_PER_PX)
