"""The port's warp-gather probes (`monodepth_tpu_torch.ops.cuda.probes` and
`monodepth_tpu_torch.tools.kernel_probe`) against the Pallas kernels of
`tools/pallas_probe.py` on the CPU.

Each JAX probe builds its kernel with `pl.pallas_call`. The tests replace
that attribute of the `pl` module the tool imported with a wrapper that
forces interpret mode, records the kernel and stops the probe, then call
the recorded kernel on their own inputs, out-of-range indices included.
The plain versions sum in the Pallas loops' order, so every case holds to
max |diff| 0 (NaN where JAX gives NaN). The CUDA kernels against their
plain versions on the card are in tests/test_torch_gpu.py."""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monodepth_tpu_torch.ops.cuda import probes
from monodepth_tpu_torch.tools import kernel_probe

ROOT = Path(__file__).resolve().parents[1]


class _Recorded(Exception):
    pass


@pytest.fixture(scope="module")
def jax_probes():
    spec = importlib.util.spec_from_file_location(
        "pallas_probe", ROOT / "tools" / "pallas_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def record(jax_probes, monkeypatch):
    """record(probe, **kw) -> the probe's Pallas kernel, in interpret mode,
    for the shapes that **kw give it."""
    real = jax_probes.pl.pallas_call
    seen = []

    def pallas_call(*args, **kwargs):
        seen.append(real(*args, **{**kwargs, "interpret": True}))
        raise _Recorded

    monkeypatch.setattr(jax_probes.pl, "pallas_call", pallas_call)

    def run(name, **kw):
        with pytest.raises(_Recorded):
            getattr(jax_probes, name)(**kw)
        return seen[-1]

    return run


def _same(ours: torch.Tensor, theirs) -> None:
    """max |diff| 0, NaN exactly where JAX has NaN."""
    ours, theirs = ours.numpy(), np.asarray(theirs)
    assert ours.shape == theirs.shape
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(theirs))
    np.testing.assert_array_equal(np.nan_to_num(ours), np.nan_to_num(theirs))


@pytest.mark.parametrize("lo,hi", [(0, 128), (-128, 0), (128, 400), (-400, -128),
                                   (-300, 300)],
                         ids=["inside", "wrap", "above", "below", "mixed"])
def test_take_along_axis_matches_jax(record, lo, hi):
    """P-A: an index in [-128, 0) wraps, any other outside [0, 128) is NaN."""
    kernel = record("probe_a")
    rng = np.random.default_rng(0)
    tab = rng.uniform(-1, 1, (8, 128)).astype(np.float32)
    idx = rng.integers(lo, hi, (8, 128)).astype(np.int32)
    ours = probes.take_along_axis(torch.from_numpy(tab), torch.from_numpy(idx))
    _same(ours, kernel(jnp.asarray(tab), jnp.asarray(idx)))
    if lo >= 128 or hi <= -128:
        assert ours.isnan().all()


@pytest.mark.parametrize("W", [128, 256, 640])
def test_row_gather_matches_jax(record, W):
    """P-B: per-sublane rows; any index outside [0, W) gives 0."""
    kernel = record("probe_b", W=W)
    rng = np.random.default_rng(W)
    row = rng.uniform(-1, 1, (8, W)).astype(np.float32)
    idx = rng.integers(-W // 2, W + W // 2, (8, W)).astype(np.int32)
    ours = probes.row_gather(torch.from_numpy(row), torch.from_numpy(idx))
    _same(ours, kernel(jnp.asarray(row), jnp.asarray(idx)))
    assert ((ours == 0) == torch.from_numpy((idx < 0) | (idx >= W))).all()


@pytest.mark.parametrize("lim", [(50, 61), (0, 64), (7, 7), (9, 3)],
                         ids=["probe", "all", "empty", "inverted"])
def test_row_sum_matches_jax(record, lim):
    """P-C at [64, 256], the bounds read on the device."""
    kernel = record("probe_c", H=64, W=256)
    src = np.random.default_rng(2).uniform(-1, 1, (64, 256)).astype(np.float32)
    lim = np.array(lim, np.int32)
    ours = probes.row_sum(torch.from_numpy(src), torch.from_numpy(lim))
    _same(ours, kernel(jnp.asarray(src), jnp.asarray(lim)))
    if lim[1] <= lim[0]:
        assert (ours == 0).all()


@pytest.mark.parametrize("n_y", [1, 4, 8, 2, 3, 5, 6, 7])
def test_slab_gather_matches_jax(record, n_y):
    """P-D at [2, 16, 256]: n_y row gathers per 8-row slab, summed in row
    order; out-of-range indices add 0."""
    B, H, W = 2, 16, 256
    kernel = record("probe_d", B=B, H=H, W=W, n_y=n_y)
    rng = np.random.default_rng(n_y)
    src = rng.uniform(-1, 1, (B, H, W)).astype(np.float32)
    idx = rng.integers(-W // 8, W + W // 8, (B, H, W)).astype(np.int32)
    ours = probes.slab_gather(torch.from_numpy(src), torch.from_numpy(idx), n_y)
    _same(ours, kernel(jnp.asarray(src), jnp.asarray(idx)))


def test_slab_gather_extreme_indices_match_jax(record):
    """P-D at [1, 8, 128], n_y = 8: rows of negative indices, of indices at
    and past W, and the int32 extremes add 0 terms, as in the Pallas
    kernel's candidate select."""
    B, H, W = 1, 8, 128
    kernel = record("probe_d", B=B, H=H, W=W, n_y=8)
    rng = np.random.default_rng(9)
    src = rng.uniform(-1, 1, (B, H, W)).astype(np.float32)
    idx = rng.integers(0, W, (B, H, W)).astype(np.int32)
    idx[0, 0] = rng.integers(-W, 0, W)
    idx[0, 1] = rng.integers(W, 2 * W, W)
    idx[0, 2] = W
    idx[0, 3, ::2], idx[0, 3, 1::2] = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    ours = probes.slab_gather(torch.from_numpy(src), torch.from_numpy(idx), 8)
    _same(ours, kernel(jnp.asarray(src), jnp.asarray(idx)))
    assert (ours[0, :4] == 0).all() and (ours[0, 4:] != 0).all()


def _slab_gather_numpy(src, idx, n_y):
    """P-D's definition in numpy, float32 sums in j order."""
    B, H, W = src.shape
    inside = (idx >= 0) & (idx < W)
    acc = np.zeros_like(src)
    for r in range(H):
        for j in range(n_y):
            row = src[:, r - r % 8 + j]
            got = np.take_along_axis(row, np.clip(idx[:, r], 0, W - 1), axis=1)
            acc[:, r] = acc[:, r] + np.where(inside[:, r], got, np.float32(0))
    return acc


def test_slab_gather_plain_has_no_kernel_limits():
    """The kernel's shared-memory width limit and 16-byte alignment hold on
    the card only: on the CPU a wider row and a view 4 bytes off go through
    the plain version, equal to P-D's definition."""
    assert [probes.slab_max_width(n) for n in (1, 4, 8)] == [57984, 14464, 7168]
    for n_y in range(1, 9):  # the widest W fits, one lane chunk more does not
        need = probes.SLAB_BARRIER + 4 * n_y * probes.slab_max_width(n_y)
        assert need <= probes.BLOCK_SMEM < need + 4 * n_y * probes.LANES
    B, H, W = 1, 16, probes.slab_max_width(8) + probes.LANES
    rng = np.random.default_rng(8)
    src = rng.uniform(-1, 1, (B, H, W)).astype(np.float32)
    idx = rng.integers(-W // 8, W + W // 8, (B, H, W)).astype(np.int32)
    expect = _slab_gather_numpy(src, idx, 8)
    buf = torch.zeros(B * H * W + 1, dtype=torch.int32)
    shifted = buf[1:].view(B, H, W)
    shifted.copy_(torch.from_numpy(idx))
    assert shifted.data_ptr() % 16 != 0
    before = probes.slab_gather.launches
    for i in (torch.from_numpy(idx), shifted):
        out = probes.slab_gather(torch.from_numpy(src), i, 8)
        np.testing.assert_array_equal(out.numpy().view(np.int32), expect.view(np.int32))
    assert probes.slab_gather.launches == before


def _f(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def _i(*shape):
    return torch.zeros(shape, dtype=torch.int32)


@pytest.mark.parametrize("call,match", [
    (lambda: probes.row_gather(_f(8, 200), _i(8, 200)), "W % 128"),
    (lambda: probes.slab_gather(_f(1, 8, 200), _i(1, 8, 200), 4), "W % 128"),
    (lambda: probes.slab_gather(_f(1, 12, 128), _i(1, 12, 128), 4), "H % 8"),
    (lambda: probes.slab_gather(_f(1, 16, 128), _i(1, 16, 128), 9), "n_y"),
    (lambda: probes.slab_gather(_f(1, 16, 128), _i(1, 16, 128), 0), "n_y"),
    (lambda: probes.take_along_axis(_f(8, 128), _i(8, 64)), "one shape"),
    (lambda: probes.take_along_axis(_f(8, 128).double(), _i(8, 128)), "float32"),
    (lambda: probes.row_gather(_f(8, 128), _i(8, 128).long()), "int32"),
    (lambda: probes.row_sum(_f(8, 128), _i(3)), r"lim \[2\]"),
], ids=["B-W", "D-W", "D-H", "D-n_y-9", "D-n_y-0", "A-shape", "A-dtype",
        "B-dtype", "C-lim"])
def test_probes_reject_what_the_tpu_kernels_cannot_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_kernel_probe_on_the_cpu(capsys):
    """The tool's four probes at small sizes through the plain versions:
    the JAX tool's lines, A-C OK, a finite D time, no kernel launch."""
    before = [f.launches for f in (probes.take_along_axis, probes.row_gather,
                                   probes.row_sum, probes.slab_gather)]
    results = [kernel_probe.probe_a("cpu"),
               kernel_probe.probe_b(W=256, device="cpu"),
               kernel_probe.probe_c(H=64, W=256, device="cpu"),
               kernel_probe.probe_d(B=2, H=16, W=256, device="cpu")]
    lines = capsys.readouterr().out.splitlines()
    assert lines[:3] == ["A take_along_axis [8,128]: OK",
                         "B full-row candidate gather W=256: OK",
                         "C dynamic fori_loop + row reads: OK"]
    assert re.fullmatch(r"D slab loop n_y=4 \[2,16,256\]: [0-9.]+ ms/channel "
                        r"\(x3 ch = [0-9.]+ ms/warp-equivalent\)", lines[3])
    assert all(r.ok for r in results) and np.isfinite(results[3].ms)
    assert results[3].out.shape == (2, 16, 256)
    assert [f.launches for f in (probes.take_along_axis, probes.row_gather,
                                 probes.row_sum, probes.slab_gather)] == before


def test_kernel_probe_main(capsys):
    """`main` at the probes' sizes: on the CPU when asked, and without a
    card it refuses the default device."""
    results = kernel_probe.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("kernel_probe on cpu\n") and out.count(": OK") == 3
    assert "D slab loop n_y=4 [12,192,640]" in out
    src, lim = kernel_probe.inputs_c()
    expect = probes.row_sum_reference(torch.from_numpy(src), torch.from_numpy(lim))
    assert torch.equal(results["C"].out, expect)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kernel_probe.main([])
