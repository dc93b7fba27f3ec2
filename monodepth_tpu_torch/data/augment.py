"""On-device colour jitter and uint8 decode, plain torch.

The host ships one uint8 frame stack and per-sample jitter factors
(brightness/contrast/saturation in [0.8, 1.2], hue in [-0.1, 0.1]); the
jitter runs on the device in the fixed order brightness -> contrast ->
saturation -> hue, as in `monodepth_tpu.data.augment`.
"""

from __future__ import annotations

import torch

from monodepth_tpu_torch.ops.sampling import device_constant
from monodepth_tpu_torch.parallel import rows

Tensor = torch.Tensor


def rgb_to_hsv(rgb: Tensor) -> Tensor:
    """[..., 3] RGB in [0,1] -> HSV (h in [0,1))."""
    r, g, b = rgb.unbind(-1)
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    v = maxc
    delta = maxc - minc
    safe = torch.where(delta > 0, delta, 1.0)
    s = torch.where(maxc > 0, delta / torch.where(maxc > 0, maxc, 1.0), 0.0)

    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return torch.stack([h, s, v], -1)


def hsv_to_rgb(hsv: Tensor) -> Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = (i.to(torch.int64) % 6)[..., None]

    def pick(*candidates):
        return torch.stack(candidates, -1).gather(-1, sector)[..., 0]

    return torch.stack([pick(v, q, p, p, t, v),
                        pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], -1)


def _grayscale(img: Tensor) -> Tensor:
    """ITU-R 601 luma, the torchvision rgb_to_grayscale convention."""
    w = device_constant((0.299, 0.587, 0.114), img.dtype, img.device)
    return (img * w).sum(-1, keepdim=True)


def color_jitter(img: Tensor, jitter: Tensor) -> Tensor:
    """Apply per-sample jitter. img: [B, ..., 3] float in [0,1];
    jitter: [B, 5] = [apply, brightness, contrast, saturation, hue]."""
    B = img.shape[0]
    expand = (B,) + (1,) * (img.ndim - 1)
    jitter = jitter.to(img.dtype)
    apply = jitter[:, 0].reshape(expand)
    bright = jitter[:, 1].reshape(expand)
    contrast = jitter[:, 2].reshape(expand)
    sat = jitter[:, 3].reshape(expand)
    hue = jitter[:, 4].reshape((B,) + (1,) * (img.ndim - 2))

    out = torch.clamp(img * bright, 0.0, 1.0)

    # contrast blends toward each frame's own gray mean, over (H, W) only
    # (the whole frame's, on row pieces: `parallel.rows`)
    gray_mean = rows.spatial_mean(_grayscale(out), (-3, -2), keepdim=True)
    out = torch.clamp(contrast * out + (1.0 - contrast) * gray_mean, 0.0, 1.0)

    out = torch.clamp(sat * out + (1.0 - sat) * _grayscale(out), 0.0, 1.0)

    hsv = rgb_to_hsv(out)
    hsv = torch.stack([(hsv[..., 0] + hue) % 1.0, hsv[..., 1], hsv[..., 2]],
                      -1)
    out = torch.clamp(hsv_to_rgb(hsv), 0.0, 1.0)

    return torch.where(apply > 0, out, img)


def decode_frames(frames_u8: Tensor, jitter: Tensor):
    """uint8 frames [B, F, H, W, 3] -> (color, color_aug) float in [0,1],
    f32 or wider if the jitter factors are wider."""
    dtype = torch.promote_types(torch.float32, jitter.dtype)
    color = frames_u8.to(dtype) / 255.0
    return color, color_jitter(color, jitter)
