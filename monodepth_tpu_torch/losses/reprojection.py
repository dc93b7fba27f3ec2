"""Monodepth2 loss assembly: per-pixel minimum reprojection with
auto-masking + edge-aware smoothness, NHWC, plain torch.

  per scale s:
    1. reprojection error of each full-res warped source vs the target
    2. auto-masking: identity error of each unwarped source vs the target,
       plus 1e-5 * N(0,1) tie-break noise drawn anew per scale
    3. per-pixel min over all (identity + reprojection) channels -> mean
    4. + disp_smoothness * smooth(disp_s, color_s) / 2^s
  total = mean over scales

The identity term does not depend on the scale, so it is computed once
(as in `monodepth_tpu.losses.reprojection`). The noise is either handed
in as {scale: 1e-5·N(0,1) tensor} or drawn from a `torch.Generator`:
`jax.random` streams cannot be reproduced in torch, so tests hand both
packages the same arrays. On a spatial mesh's row pieces
(`parallel.rows`) the total is this rank's part of the loss: the spatial
ranks' parts add up to it, and the noise handed in is this rank's rows.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence, Union

import torch

from monodepth_tpu_torch.losses.smoothness import smooth_loss
from monodepth_tpu_torch.ops.ssim import reprojection_error
from monodepth_tpu_torch.parallel import rows

Tensor = torch.Tensor
Noise = Union[Mapping[int, Tensor], torch.Generator]


def min_reprojection(reproj: Tensor, identity: Tensor | None,
                     noise: Tensor | None) -> Tensor:
    """Per-pixel minimum over reprojection (+ noisy identity) channels.
    reproj, identity, noise: [B, H, W, F] (identity None = automask off).
    Returns [B, H, W]."""
    if identity is None:
        combined = reproj
    else:
        combined = torch.cat([identity + noise, reproj], -1)
    if combined.shape[-1] == 1:
        return combined[..., 0]
    return combined.amin(-1)


def plain_photometric_min(warps: Sequence[Tensor], target: Tensor,
                          identity: Tensor | None, noise: Tensor | None):
    """One scale's photometric term as plain torch: `reprojection_error` of
    each warp against `target`, and the per-pixel minimum over them and
    the noisy identity (`min_reprojection`) -> (minimum [B, H, W], the
    channels [B, H, W, n] it is taken over, identity channels first). The
    specification the photometric kernels (`ops.cuda.photometric`) keep."""
    reproj = torch.cat([reprojection_error(w, target) for w in warps], -1)
    combined = reproj if identity is None else torch.cat([identity + noise, reproj], -1)
    return min_reprojection(combined, None, None), combined


def tie_noise(generator: torch.Generator, shape, dtype: torch.dtype,
              device) -> Tensor:
    """One scale's tie-break noise, 1e-5·N(0, 1), as `monodepth_loss`
    draws it from a generator."""
    return 1e-5 * torch.randn(shape, generator=generator, dtype=dtype,
                              device=device)


def monodepth_loss(
    disp_pyramid: Mapping[int, Tensor],
    warped_colors: Mapping[int, Sequence[Tensor]],
    source_colors: Sequence[Tensor],
    color_pyramid: Sequence[Tensor],
    noise: Noise,
    *,
    scales: Sequence[int] = (0, 1, 2, 3),
    disp_smoothness: float = 1e-3,
    use_automasking: bool = True,
    choices: bool = False,
    photometric: Any = None,
) -> tuple[Tensor, dict]:
    """Total loss and {photometric/s, smooth/s} terms; with `choices` also
    {choice/s: [B, H, W] int64}, the channel each pixel's minimum takes
    (the identity channels first, then the reprojections). `photometric`
    computes each scale's minimum instead of `plain_photometric_min`: the
    module `ops.cuda.photometric` (its `identity_errors`,
    `photometric_min` and `first_choice`), which the train and eval steps
    pass with the kernels on; its values are the composition's.

    disp_pyramid:   scale -> [B, H/2^s, W/2^s, 1] sigmoid disparity
    warped_colors:  scale -> per-source full-res warps [B, H, W, 3]
    source_colors:  per-source full-res unwarped colors [B, H, W, 3]
    color_pyramid:  scale -> target color at that scale (0 = full res)
    noise:          {scale: [B, H, W, F] tie-break noise} or a generator
    """
    target = color_pyramid[0]

    identity = None
    if use_automasking and photometric is not None:
        identity = photometric.identity_errors(source_colors, target)
    elif use_automasking:
        identity = torch.cat(
            [reprojection_error(src, target) for src in source_colors], -1)

    # on row pieces a coarse scale's level may run whole (`parallel.rows`'
    # level rule, the depth decoder's levels): every rank then holds its
    # smoothness whole, and each adds its share
    levels = rows.resnet_levels()
    aux = {}
    total = 0.0
    for scale in scales:
        tie = None
        if identity is not None:
            if isinstance(noise, torch.Generator):
                tie = tie_noise(noise, identity.shape, identity.dtype,
                                identity.device)
            else:
                tie = noise[scale].to(identity.device, identity.dtype)
        if photometric is not None:
            minimum, mask = photometric.photometric_min(
                warped_colors[scale], target, identity, tie)
            if choices:
                aux[f"choice/{scale}"] = photometric.first_choice(mask)
        else:
            minimum, combined = plain_photometric_min(
                warped_colors[scale], target, identity, tie)
            if choices:
                aux[f"choice/{scale}"] = combined.detach().argmin(-1)
        term = rows.loss_mean(minimum)

        with rows.level(levels[scale]):
            smooth = smooth_loss(disp_pyramid[scale], color_pyramid[scale])
        if rows.current() is not None and not levels[scale]:
            smooth = smooth / rows.current().n
        aux[f"photometric/{scale}"] = term
        aux[f"smooth/{scale}"] = smooth
        total = total + (term + disp_smoothness * smooth / (2 ** scale))

    return total / len(scales), aux
