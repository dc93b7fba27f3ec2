"""Native (C++) host-pipeline bindings via ctypes: JPEG decode + Lanczos
resize, the loader's host decoder.

`host_pipeline.cc` is a copy of the JAX package's. It is built on first
use, never at import, with `g++ -O3 -march=native ... -ljpeg` into
`build/native/libmdt_host-<host key>.so` beside the package (next to the
CUDA kernels' `build/cuda/`). The key hashes the host's CPU feature flags,
so a checkout shared by hosts of different instruction sets never loads
another host's `-march=native` binary. ctypes releases the GIL for the
call, so the loader's thread pool decodes on every core.

Without `g++` or libjpeg, `available()` is False and the dataset decodes
with PIL. This is a host decoder; the card does not see it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "host_pipeline.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"


def _host_key() -> str:
    """Cache key for the host's CPU microarchitecture: its CPU feature
    flags (the instruction-set surface -march=native compiles against);
    the hostname where /proc/cpuinfo is unreadable, which disables
    sharing across hosts rather than colliding."""
    feat = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feat += " " + " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        feat += f" no-cpu-flags {platform.node()}"
    return hashlib.sha1(feat.encode()).hexdigest()[:12]


def library_path() -> Path:
    return BUILD_DIR / f"libmdt_host-{_host_key()}.so"


_lock = threading.Lock()
_lib = None
_tried = False


def _build(target: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # pid-suffixed temp so concurrent builders never clobber each other
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           str(_SRC), "-o", str(tmp), "-ljpeg"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, target)
        return True
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as e:
        tmp.unlink(missing_ok=True)
        stderr = getattr(e, "stderr", None) or b""
        print(f">>> native host pipeline build failed ({e}); "
              f"falling back to PIL. {stderr[:500]!r}")
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        target = library_path()
        if not target.exists() or target.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build(target):
                return None
        lib = ctypes.CDLL(str(target))
        lib.mdt_decode_resize.restype = ctypes.c_int
        lib.mdt_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_resize(path: str, height: int, width: int,
                  flip: bool = False) -> np.ndarray:
    """JPEG file -> [height, width, 3] uint8 RGB (Lanczos, optional
    horizontal flip). Raises RuntimeError on decode failure."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native host pipeline unavailable")
    with open(path, "rb") as f:
        data = f.read()
    out = np.empty((height, width, 3), dtype=np.uint8)
    rc = lib.mdt_decode_resize(
        data, len(data), height, width, int(flip),
        out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"jpeg decode failed: {path}")
    return out
