"""The warp-gather probes: hand-written CUDA kernels and their plain torch versions.

Counterparts of the four Pallas kernels of `tools/pallas_probe.py`, the
building blocks of a warp sampler's tap gathers (float32 data, int32
indices):

- `take_along_axis(tab, idx)` (P-A), tab and idx [S, L]:
  out[s, l] = tab[s, idx[s, l]] with `jnp.take_along_axis`'s rule: an
  index in [-L, 0) wraps to idx + L, any other outside [0, L) gives NaN.
- `row_gather(row, idx)` (P-B, the candidate select `_row_gather`), row
  and idx [S, W], W % 128 == 0: out[s, l] = row[s, idx[s, l]] where
  0 <= idx < W, else 0.
- `row_sum(src, lim)` (P-C), src [H, W], lim [2]: out [1, W] is the sum of
  rows lim[0] .. lim[1] - 1 in that order, 0 when lim[1] <= lim[0]. The
  kernel reads the bounds on the device (no host sync) and clamps them to
  [0, H]; the TPU kernel leaves bounds outside that undefined.
- `slab_gather(src, idx, n_y)` (P-D), src and idx [B, H, W], H % 8 == 0,
  W % 128 == 0, 1 <= n_y <= 8: out[b, r, l] is the sum over j < n_y, in j
  order, of src[b, 8·(r // 8) + j, idx[b, r, l]], each term 0 where idx is
  outside [0, W). An n_y above 8 would read past the last slab and raises.
  The kernel stages a slab's n_y source rows in shared memory, so on the
  card W <= `slab_max_width(n_y)` (7,168 at n_y = 8) and src and idx start
  on 16 bytes (a view with a storage offset may not); beyond either it
  raises ValueError. The plain version has neither limit.

On a CUDA tensor each launches its entry point of `csrc/probes.cu` (built
with nvcc for sm_90a at first use, bound with ctypes) on the current
stream, or raises. On a CPU tensor each runs its plain version
(`*_reference`), which sums in the kernel's order and so rounds alike.
`fn.launches` counts kernel launches (not plain-version calls). Shapes and
types outside the above raise ValueError on either device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from monodepth_tpu_torch.ops.cuda.build import load_library

Tensor = torch.Tensor

LANES = 128  # the TPU probes' chunk width: P-B and P-D need W % 128 == 0
SLAB = 8     # rows per slab of P-D
BLOCK_SMEM = 232_448  # bytes of shared memory a Hopper block can hold (227 KB)
SLAB_BARRIER = 16     # bytes of P-D's block ahead of its rows (kBarrierBytes in probes.cu)


def _need(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name} {what}")


def _check_types(name: str, data: Tensor, index: Tensor) -> None:
    _need(data.dtype == torch.float32 and index.dtype == torch.int32, name,
          f"takes float32 data and int32 indices; got {data.dtype}, {index.dtype}")
    _need(data.device == index.device, name,
          f"needs one device; got {data.device} and {index.device}")


def _check_gather(name: str, data: Tensor, idx: Tensor, lanes: int = 1) -> None:
    _check_types(name, data, idx)
    _need(data.ndim == 2 and idx.shape == data.shape, name,
          f"needs data and idx of one shape [S, W]; got {tuple(data.shape)}, "
          f"{tuple(idx.shape)}")
    _need(data.shape[1] % lanes == 0, name,
          f"needs W % {lanes} == 0; got W = {data.shape[1]}")


def _check_row_sum(src: Tensor, lim: Tensor) -> None:
    _check_types("row_sum", src, lim)
    _need(src.ndim == 2 and tuple(lim.shape) == (2,), "row_sum",
          f"needs src [H, W] and lim [2]; got {tuple(src.shape)}, {tuple(lim.shape)}")


def _check_slab(src: Tensor, idx: Tensor, n_y: int) -> None:
    name = "slab_gather"
    _check_types(name, src, idx)
    _need(src.ndim == 3 and idx.shape == src.shape, name,
          f"needs src and idx of one shape [B, H, W]; got {tuple(src.shape)}, "
          f"{tuple(idx.shape)}")
    _need(src.shape[1] % SLAB == 0 and src.shape[2] % LANES == 0, name,
          f"needs H % {SLAB} == 0 and W % {LANES} == 0; got {tuple(src.shape)}")
    _need(1 <= n_y <= SLAB, name,
          f"needs 1 <= n_y <= {SLAB} (a slab has {SLAB} rows); got {n_y}")


def slab_max_width(n_y: int) -> int:
    """The widest W (a multiple of 128) whose n_y float32 rows P-D's kernel
    holds in one block's shared memory."""
    return (BLOCK_SMEM - SLAB_BARRIER) // (4 * n_y) // LANES * LANES


def _check_slab_kernel(src: Tensor, idx: Tensor, n_y: int) -> None:
    """What P-D's kernel needs beyond `_check_slab`."""
    name, W = "slab_gather", src.shape[2]
    _need(W <= slab_max_width(n_y), name,
          f"kernel holds n_y rows in shared memory: W <= {slab_max_width(n_y)} at "
          f"n_y = {n_y} ({BLOCK_SMEM} bytes a block); got W = {W}")
    _need(src.data_ptr() % 16 == 0 and idx.data_ptr() % 16 == 0, name,
          "kernel needs src and idx on 16-byte boundaries (a view with a storage "
          f"offset may not be); got addresses {src.data_ptr():#x}, {idx.data_ptr():#x}")


def take_along_axis_reference(tab: Tensor, idx: Tensor) -> Tensor:
    """Plain torch version of P-A."""
    _check_gather("take_along_axis", tab, idx)
    L = tab.shape[1]
    i = torch.where(idx < 0, idx + L, idx)
    got = torch.gather(tab, 1, i.clamp(0, L - 1).long())
    return torch.where((i >= 0) & (i < L), got, float("nan"))


def row_gather_reference(row: Tensor, idx: Tensor) -> Tensor:
    """Plain torch version of P-B."""
    _check_gather("row_gather", row, idx, LANES)
    W = row.shape[1]
    got = torch.gather(row, 1, idx.clamp(0, W - 1).long())
    return torch.where((idx >= 0) & (idx < W), got, 0.0)


def row_sum_reference(src: Tensor, lim: Tensor) -> Tensor:
    """Plain torch version of P-C. It reads the bounds on the host."""
    _check_row_sum(src, lim)
    lo, hi = lim.clamp(0, src.shape[0]).tolist()
    acc = torch.zeros((1, src.shape[1]), dtype=src.dtype, device=src.device)
    for y in range(lo, hi):
        acc = acc + src[y:y + 1]
    return acc


def slab_gather_reference(src: Tensor, idx: Tensor, n_y: int) -> Tensor:
    """Plain torch version of P-D."""
    _check_slab(src, idx, n_y)
    B, H, W = src.shape
    inside = (idx >= 0) & (idx < W)
    safe = idx.clamp(0, W - 1).long()
    slabs = src.reshape(B, H // SLAB, SLAB, W)
    acc = torch.zeros_like(src)
    for j in range(n_y):
        row = slabs[:, :, j:j + 1].expand(B, H // SLAB, SLAB, W).reshape(B, H, W)
        acc = acc + torch.where(inside, torch.gather(row, 2, safe), 0.0)
    return acc


def _launch(fn, inputs, out: Tensor, *sizes: int) -> Tensor:
    """Launch `fn`'s entry point of the library on the inputs' card, into
    `out`, and count the launch on `fn`."""
    device = inputs[0].device
    if device.type != "cuda":
        raise ValueError(f"{fn.__name__} runs on cuda or cpu, not {device}")
    _need(all(t.is_contiguous() for t in inputs), fn.__name__,
          "kernel takes contiguous tensors")
    entry = getattr(_kernel_library(), f"probe_{fn.__name__}")
    with torch.cuda.device(device):
        err = entry(*(t.data_ptr() for t in inputs), out.data_ptr(), *sizes,
                    torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_{fn.__name__} launch failed: CUDA error {err}")
    fn.launches += 1
    return out


def take_along_axis(tab: Tensor, idx: Tensor) -> Tensor:
    """P-A: tab [S, L] float32 at idx [S, L] int32 -> [S, L]."""
    if tab.device.type == "cpu":
        return take_along_axis_reference(tab, idx)
    _check_gather("take_along_axis", tab, idx)
    return _launch(take_along_axis, (tab, idx), torch.empty_like(tab), *tab.shape)


def row_gather(row: Tensor, idx: Tensor) -> Tensor:
    """P-B: row [S, W] float32 at idx [S, W] int32 -> [S, W]."""
    if row.device.type == "cpu":
        return row_gather_reference(row, idx)
    _check_gather("row_gather", row, idx, LANES)
    return _launch(row_gather, (row, idx), torch.empty_like(row), *row.shape)


def row_sum(src: Tensor, lim: Tensor) -> Tensor:
    """P-C: the sum of rows lim[0] .. lim[1] - 1 of src [H, W] -> [1, W]."""
    if src.device.type == "cpu":
        return row_sum_reference(src, lim)
    _check_row_sum(src, lim)
    out = torch.empty((1, src.shape[1]), dtype=src.dtype, device=src.device)
    return _launch(row_sum, (src, lim), out, *src.shape)


def slab_gather(src: Tensor, idx: Tensor, n_y: int) -> Tensor:
    """P-D: n_y row gathers per 8-row slab, summed -> [B, H, W]."""
    if src.device.type == "cpu":
        return slab_gather_reference(src, idx, n_y)
    _check_slab(src, idx, n_y)
    _check_slab_kernel(src, idx, n_y)
    return _launch(slab_gather, (src, idx), torch.empty_like(src), *src.shape, n_y)


take_along_axis.launches = row_gather.launches = row_sum.launches = \
    slab_gather.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel_library() -> ctypes.CDLL:
    lib = load_library("probes")
    for name, n_ints in (("take_along_axis", 2), ("row_gather", 2),
                         ("row_sum", 2), ("slab_gather", 4)):
        fn = getattr(lib, f"probe_{name}")
        # three pointers (two inputs, out), the sizes, the stream
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
