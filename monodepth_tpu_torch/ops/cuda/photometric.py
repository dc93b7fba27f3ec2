"""The photometric term of one scale: hand-written CUDA kernels and their plain torch versions.

`monodepth_loss` takes, per scale, the per-pixel minimum over the channels
[identity + noise, reprojection errors of the warps], each error SSIM+L1
of an image against the target (`ops.ssim.reprojection_error`). Here that
term is two functions:

- `identity_errors(sources, target)` -> [B, H, W, F]: each unwarped
  source's error, forward only (once a step: it does not depend on the
  scale);
- `photometric_min(warps, target, identity, noise)` -> (minimum [B, H, W],
  mask [B, H, W] uint8): the minimum over [identity + noise, errors of
  `warps`] in that order (`identity` None: automasking off, the errors
  alone), with a gradient with respect to each warp; the mask holds bit k
  for each channel k that ties at the minimum, or, where the minimum is
  NaN, bit 7 and the bit of the first NaN channel, so its lowest set bit
  is argmin's index (`first_choice`).

On a CUDA tensor `identity_errors` is one launch of `photometric_identity`
and `photometric_min` one of `photometric_min_fwd`, whose backward
(`PhotometricMin`) is one launch of `photometric_min_bwd`
(`photometric_min_grads`): `csrc/photometric.cu`, built with nvcc for
sm_90a at first use and bound with ctypes, run on the current stream,
outputs allocated with `torch.empty`; a launch that fails raises. The
kernels take contiguous float32 [B, H, W, 3] images, H and W >= 2 and
1-3 sources; anything else raises. The backward reads the forward's mask
and the images, not a saved error map; amin's even split among tied
channels comes from the mask's bits. The minimum's cotangent is read as
one float where it is expanded from a scalar (every stride 0), and
otherwise made contiguous, which copies nothing where autograd hands it
contiguous (the mean's backward does). The sources, the target, the
identity and the noise get no gradient: they carry none in any step, and
the wrapper raises if the target or the identity asks for one. The
bounds are in the CUDA source.

On a CPU tensor each takes its plain version, the composition
`monodepth_loss` has without kernels (`losses.reprojection.
plain_photometric_min`, which `photometric_min_reference` calls):
`reprojection_error` per image, `torch.cat`, `+ noise`, `amin`,
differentiated by autograd, so the values and gradients are that
composition's bit for bit. The train and eval steps take the kernels on
a card only (`training.step._photometric`). `photometric_min_grads_reference` is the plain
version of the backward kernel: autograd through `reprojection_error`
with each channel's share of the cotangent read from a mask
(`mask_cotangent`), the split `amin`'s autograd makes.

`identity_errors.launches`, `photometric_min.launches` and
`photometric_min_grads.launches` count kernel launches (not plain-version
calls).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from monodepth_tpu_torch.losses.reprojection import plain_photometric_min
from monodepth_tpu_torch.ops.cuda.build import load_library
from monodepth_tpu_torch.ops.ssim import reprojection_error

Tensor = torch.Tensor

NAN_MIN = 0x80  # the mask's bit for a NaN minimum


def tie_mask(combined: Tensor, minimum: Tensor) -> Tensor:
    """The kernels' mask of `minimum` [B, H, W] over `combined`
    [B, H, W, n]: bit k where channel k equals it; where it is NaN,
    `NAN_MIN` and the bit of the first NaN channel."""
    n = combined.shape[-1]
    weights = torch.tensor([1 << k for k in range(n)], dtype=torch.int32,
                           device=combined.device)
    ties = ((combined == minimum[..., None]).to(torch.int32) * weights).sum(-1)
    first_nan = NAN_MIN | weights[combined.isnan().to(torch.int32).argmax(-1)]
    return torch.where(minimum.isnan(), first_nan, ties).to(torch.uint8)


def first_choice(mask: Tensor) -> Tensor:
    """The channel each pixel's minimum takes, int64: the mask's lowest set
    bit, argmin's index (the first of tied channels; the first NaN one)."""
    bits = (mask[..., None].to(torch.int64)
            >> torch.arange(7, device=mask.device)) & 1
    return bits.argmax(-1)


def mask_cotangent(mask: Tensor, dmin: Tensor, channels: int) -> Tensor:
    """Each of `channels` channels' share of the minimum's cotangent `dmin`
    [B, H, W] -> [B, H, W, channels]: amin's autograd split, bit_k *
    (dmin / popcount); a NaN minimum gives NaN to every channel (amin's 0 *
    (g / 0)); a single channel takes `dmin` whole."""
    if channels == 1:
        return dmin[..., None].clone()
    m = mask.to(torch.int64)
    bits = ((m[..., None] >> torch.arange(channels, device=mask.device)) & 1)
    bits = torch.where((m & NAN_MIN)[..., None] != 0, 0, bits).to(dmin.dtype)
    return bits * (dmin / bits.sum(-1))[..., None]


def photometric_min_reference(warps: Sequence[Tensor], target: Tensor,
                              identity: Tensor | None, noise: Tensor | None):
    """Plain version of `photometric_min`: `monodepth_loss`'s composition
    (`plain_photometric_min`), differentiated by autograd -> (minimum,
    mask)."""
    minimum, combined = plain_photometric_min(warps, target, identity, noise)
    return minimum, tie_mask(combined.detach(), minimum.detach())


def photometric_min_grads_reference(warps: Sequence[Tensor], target: Tensor,
                                    mask: Tensor, dmin: Tensor,
                                    automask: bool) -> list:
    """Plain version of the backward kernel: each warp's gradient from the
    cotangent `dmin` of the minimum whose tie mask is `mask`, by autograd
    through `reprojection_error` with each warp's channel share
    (`mask_cotangent`)."""
    F = len(warps)
    share = mask_cotangent(mask, dmin, 2 * F if automask else F)[..., -F:]
    with torch.enable_grad():
        leaves = [w.detach().requires_grad_(True) for w in warps]
        errors = [reprojection_error(w, target.detach()) for w in leaves]
        return list(torch.autograd.grad(errors, leaves,
                                        [share[..., f:f + 1] for f in range(F)]))


def _check(images: Sequence[Tensor], target: Tensor, name: str) -> None:
    if target.ndim != 4:
        raise ValueError(f"{name} needs target [B, H, W, C]; got {tuple(target.shape)}")
    if not 1 <= len(images) <= 3:
        raise ValueError(f"{name} takes 1 to 3 images; got {len(images)}")
    for t in images:
        if t.shape != target.shape:
            raise ValueError(f"{name} needs images shaped like the target "
                             f"{tuple(target.shape)}; got {tuple(t.shape)}")
        if t.device != target.device:
            raise ValueError(f"{name}: an image on {t.device}, the target on {target.device}")


def _kernel_check(tensors: Sequence[Tensor], name: str) -> None:
    """What the kernels take: contiguous float32 on a CUDA device, C = 3,
    H, W >= 2."""
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {first.device}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32; got {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"{name}: tensors on {t.device} and {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous tensors")
    B, H, W, C = first.shape
    if C != 3 or H < 2 or W < 2:
        raise ValueError(f"{name} kernel takes [B, H, W, 3] with H, W >= 2; "
                         f"got {tuple(first.shape)}")


def _pointers(images: Sequence[Tensor]) -> list:
    return [t.data_ptr() for t in images] + [None] * (3 - len(images))


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def identity_errors(sources: Sequence[Tensor], target: Tensor) -> Tensor:
    """Each source's SSIM+L1 error against `target` -> [B, H, W, F]: the
    kernel on CUDA tensors, `reprojection_error` per source on CPU tensors.
    No gradient."""
    _check(sources, target, "identity_errors")
    if target.device.type == "cpu":
        return torch.cat([reprojection_error(s, target) for s in sources], -1)
    _kernel_check([target, *sources], "identity_errors")
    B, H, W, _ = target.shape
    errors = target.new_empty((B, H, W, len(sources)))
    with torch.cuda.device(target.device):
        err = _kernel_library().photometric_identity(
            target.data_ptr(), *_pointers(sources), errors.data_ptr(), len(sources),
            B, H, W, _stream(target))
    if err != 0:
        raise RuntimeError(f"photometric_identity launch failed: CUDA error {err}")
    identity_errors.launches += 1
    return errors


identity_errors.launches = 0


def _forward(warps: Sequence[Tensor], target: Tensor, identity: Tensor | None,
             noise: Tensor | None):
    """One launch of the forward kernel -> (minimum, mask)."""
    extra = [] if identity is None else [identity, noise]
    _kernel_check([target, *warps, *extra], "photometric_min")
    B, H, W, _ = target.shape
    for t in extra:
        if t.shape != (B, H, W, len(warps)):
            raise ValueError(f"photometric_min needs identity and noise "
                             f"[B, H, W, {len(warps)}]; got {tuple(t.shape)}")
    minimum = target.new_empty((B, H, W))
    mask = torch.empty((B, H, W), dtype=torch.uint8, device=target.device)
    with torch.cuda.device(target.device):
        err = _kernel_library().photometric_min_fwd(
            target.data_ptr(), *_pointers(warps),
            *([t.data_ptr() for t in extra] if extra else [None, None]),
            minimum.data_ptr(), mask.data_ptr(), len(warps), B, H, W, _stream(target))
    if err != 0:
        raise RuntimeError(f"photometric_min_fwd launch failed: CUDA error {err}")
    photometric_min.launches += 1
    return minimum, mask


def photometric_min_grads(warps: Sequence[Tensor], target: Tensor, mask: Tensor,
                          dmin: Tensor, automask: bool) -> list:
    """Each warp's gradient [B, H, W, 3] from the cotangent `dmin` [B, H, W]
    of the minimum whose tie mask is `mask` (`photometric_min_grads_reference`):
    one kernel launch on CUDA tensors, the plain version on CPU tensors.
    `dmin` may be expanded from a scalar (read as one float) or strided
    (made contiguous)."""
    _check(warps, target, "photometric_min_grads")
    if target.device.type == "cpu":
        return photometric_min_grads_reference(warps, target, mask, dmin, automask)
    _kernel_check([target, *warps], "photometric_min_grads")
    B, H, W, _ = target.shape
    if mask.shape != (B, H, W) or mask.dtype != torch.uint8 or not mask.is_contiguous():
        raise ValueError(f"photometric_min_grads needs a contiguous uint8 mask "
                         f"[B, H, W]; got {mask.dtype} {tuple(mask.shape)}")
    if dmin.shape != (B, H, W) or dmin.dtype != torch.float32 \
            or dmin.device != target.device:
        raise ValueError(f"photometric_min_grads needs a float32 cotangent "
                         f"[B, H, W] on {target.device}; got {dmin.dtype} "
                         f"{tuple(dmin.shape)} on {dmin.device}")
    scalar = all(s == 0 for s in dmin.stride())
    if not scalar:
        dmin = dmin.contiguous()
    grads = [torch.empty_like(w) for w in warps]
    with torch.cuda.device(target.device):
        err = _kernel_library().photometric_min_bwd(
            target.data_ptr(), *_pointers(warps), mask.data_ptr(), dmin.data_ptr(),
            int(scalar), *_pointers(grads), len(warps), int(automask), B, H, W,
            _stream(target))
    if err != 0:
        raise RuntimeError(f"photometric_min_bwd launch failed: CUDA error {err}")
    photometric_min_grads.launches += 1
    return grads


photometric_min_grads.launches = 0


class PhotometricMin(torch.autograd.Function):
    """The forward and backward kernels as one autograd step:
    `PhotometricMin.apply(target, identity, noise, *warps)` -> (minimum,
    mask); the mask takes no gradient, and only the warps get one."""

    @staticmethod
    def forward(ctx, target: Tensor, identity, noise, *warps: Tensor):
        minimum, mask = _forward(warps, target, identity, noise)
        ctx.save_for_backward(target, mask, *warps)
        ctx.mark_non_differentiable(mask)
        ctx.automask = identity is not None
        return minimum, mask

    @staticmethod
    def backward(ctx, dmin: Tensor, _):
        target, mask, *warps = ctx.saved_tensors
        grads = photometric_min_grads(warps, target, mask, dmin, ctx.automask)
        return (None, None, None, *grads)


def photometric_min(warps: Sequence[Tensor], target: Tensor,
                    identity: Tensor | None, noise: Tensor | None):
    """The per-pixel minimum over [identity + noise, errors of `warps`] ->
    (minimum [B, H, W], mask [B, H, W] uint8), differentiable with respect
    to the warps: the kernels on CUDA tensors (`PhotometricMin`), the plain
    composition on CPU tensors (`photometric_min_reference`). `identity`
    and `noise` [B, H, W, F], or both None (automasking off)."""
    _check(warps, target, "photometric_min")
    if (identity is None) != (noise is None):
        raise ValueError("photometric_min takes identity and noise together, or neither")
    if target.device.type == "cpu":
        return photometric_min_reference(warps, target, identity, noise)
    if target.requires_grad or (identity is not None and identity.requires_grad):
        raise ValueError("photometric_min gives no gradient to the target or "
                         "the identity; they must not need one")
    return PhotometricMin.apply(target, identity, noise, *warps)


photometric_min.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    lib = load_library("photometric")
    # images, then (F, B, H, W) / (F, automask, B, H, W), then the stream
    for fn, n_ptrs, n_ints in ((lib.photometric_identity, 5, 4),
                               (lib.photometric_min_fwd, 8, 4)):
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.photometric_min_bwd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.photometric_min_bwd.restype = ctypes.c_int
    return lib
