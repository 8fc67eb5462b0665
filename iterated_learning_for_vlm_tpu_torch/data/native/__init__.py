"""Native (C) fused augmentation: build and ctypes bindings.

The loader's host hot path (crop-resize -> color jitter -> grayscale -> blur
-> flip -> normalize) runs as ONE C call per image (``fused_augment.c``, a
byte-for-byte copy of the JAX package's source, so the two cannot drift). The
call releases the GIL, so the pipeline's thread pool scales across the host's
cores.

Build: at first use, ``g++ -O3 -march=native -ffp-contract=off -fPIC
-shared`` (retried without ``-march=native`` for toolchains that lack it)
into ``build/torch_native/`` at the checkout root (git-ignored), named by a
hash of the source, the CPU's flags and the compiler flags, so an edited
source or another host's ISA rebuilds. ``-ffp-contract=off`` keeps the
jitter / HSV arithmetic bit-exact with PIL's: FMA contraction changes its
truncations. If the compiler is missing or fails, :func:`get_lib` logs the
compiler's stderr at WARNING and returns None, and ``data/augment.py`` takes
the PIL path. ``ILVLM_NATIVE_AUGMENT=0`` forces the PIL path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import tempfile
import threading
from pathlib import Path

import numpy as np

from ...utils.logging import get_logger

logger = get_logger("data.native")

_SRC = Path(__file__).resolve().parent / "fused_augment.c"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_native"
_CFLAGS = ["-O3", "-march=native", "-ffp-contract=off"]
_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _cpu_tag() -> bytes:
    """ISA fingerprint: a -march=native binary must not be loaded on a host
    with other CPU flags (a shared checkout)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return os.uname().machine.encode()


def library_path() -> Path:
    key = _SRC.read_bytes() + _cpu_tag() + " ".join(_CFLAGS).encode()
    tag = hashlib.sha256(key).hexdigest()[:16]
    ext = sysconfig.get_config_var("SHLIB_SUFFIX") or ".so"
    return BUILD_DIR / f"fused_augment-{tag}{ext}"


def _compile(cmd) -> None:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {res.returncode}:\n{res.stderr}")


def build() -> Path:
    """Compile the library unless a build of this source, CPU and flags exists.
    Writes a temporary name and renames it, so processes building at once
    never load a half-written file."""
    so_path = library_path()
    if so_path.is_file():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=so_path.suffix, dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *_CFLAGS, "-fPIC", "-shared", "-o", tmp, str(_SRC), "-lm"]
    try:
        try:
            _compile(cmd)
        except RuntimeError as first:
            # some toolchains lack -march=native (cross / emulated): portable retry
            logger.warning("native augment: %s; retrying without -march=native", first)
            cmd.remove("-march=native")
            _compile(cmd)
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.fused_augment.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int,                       # src, h, w
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,  # box
        ctypes.c_int,                                            # out_size
        _I32P, _F64P, ctypes.c_int,                              # jitter ops/factors/n
        ctypes.c_int, ctypes.c_double, ctypes.c_int,             # gray, sigma, flip
        _F32P, _F32P,                                            # norm scale/offset
        _F32P,                                                   # out
    ]
    lib.fused_augment.restype = ctypes.c_int
    lib.fused_resize_box.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        _U8P, ctypes.c_int, ctypes.c_int,
    ]
    lib.fused_resize_box.restype = ctypes.c_int
    for name in ("fused_rgb2hsv", "fused_hsv2rgb"):
        fn = getattr(lib, name)
        fn.argtypes = [_U8P, _U8P, ctypes.c_int]
        fn.restype = None
    lib.fused_gray.argtypes = [_U8P, _U8P, ctypes.c_int]
    lib.fused_gray.restype = None
    return lib


def get_lib():
    """The bound shared library, or None where native augment is unavailable
    (no g++, a compile failure, or ``ILVLM_NATIVE_AUGMENT=0``)."""
    global _LIB, _TRIED
    if os.environ.get("ILVLM_NATIVE_AUGMENT", "").strip() == "0":
        return None
    if _TRIED:
        return _LIB
    with _LOCK:
        if _TRIED:
            return _LIB
        try:
            _LIB = _bind(ctypes.CDLL(str(build())))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            logger.warning("native augment unavailable; using the PIL path: %s", e)
            _LIB = None
        _TRIED = True
    return _LIB


def available() -> bool:
    return get_lib() is not None


def fused_augment(
    src: np.ndarray,
    box,
    out_size: int,
    jitter_ops,
    jitter_factors,
    grayscale: bool,
    blur_sigma: float,
    flip: bool,
    norm_scale: np.ndarray,
    norm_offset: np.ndarray,
) -> np.ndarray:
    """Run the fused chain on an HxWx3 uint8 array; returns SxSx3 float32."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native augment is not available")
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"fused_augment takes an HxWx3 uint8 image, got shape {src.shape}")
    h, w = src.shape[:2]
    ops = np.asarray(jitter_ops, dtype=np.int32)
    factors = np.asarray(jitter_factors, dtype=np.float64)
    out = np.empty((out_size, out_size, 3), dtype=np.float32)
    bx, by, bw, bh = (float(v) for v in box)
    rc = lib.fused_augment(
        src, h, w, bx, by, bw, bh, int(out_size),
        ops, factors, len(ops),
        int(bool(grayscale)), float(blur_sigma), int(bool(flip)),
        np.ascontiguousarray(norm_scale, dtype=np.float32),
        np.ascontiguousarray(norm_offset, dtype=np.float32),
        out,
    )
    if rc != 0:
        raise RuntimeError(f"fused_augment failed with code {rc}")
    return out


def resize_box(src: np.ndarray, box, out_w: int, out_h: int) -> np.ndarray:
    """PIL-style bicubic box resize of an HxWx3 uint8 array (test surface)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native augment is not available")
    src = np.ascontiguousarray(src, dtype=np.uint8)
    h, w = src.shape[:2]
    dst = np.empty((out_h, out_w, 3), dtype=np.uint8)
    bx, by, bw, bh = (float(v) for v in box)
    rc = lib.fused_resize_box(src, h, w, bx, by, bw, bh, dst, out_w, out_h)
    if rc != 0:
        raise RuntimeError(f"resize_box failed with code {rc}")
    return dst
