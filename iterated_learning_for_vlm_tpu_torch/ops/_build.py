"""Build and bind the hand-written Hopper kernels (``csrc/*.cu``).

Counterpart of the JAX package's ``ops/_common.py``: the one place that
decides how kernels are compiled and called. At first use, ``nvcc`` compiles
every ``csrc/*.cu`` for ``sm_90a`` (one process per source, all started
together) and links the objects into one shared library with a plain C
interface under ``build/torch_kernels/`` at the checkout root (git-ignored),
named by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. The library is loaded with ``ctypes``; nothing here
includes PyTorch's headers, which keeps a cold build to seconds.

Binding rules every wrapper follows:

- ``argtypes`` declare ``c_void_p`` for each pointer and the stream, so a
  64-bit address is never cut to an int;
- the stream is ``torch.cuda.current_stream().cuda_stream``: kernels run on
  PyTorch's current stream and do not synchronise;
- each C entry returns ``cudaGetLastError()`` after its launch, and
  :func:`check` raises when it is not 0.

Nothing is compiled or loaded at import time: the CPU tests import every
module of the port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else ``nvcc`` on PATH."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                           "the port's CUDA kernels are built from csrc/ at first use")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libilvlm_kernels_{_digest()}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; wait for all, then raise on the first that
    failed. Returns their output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Path:
    """Compile the kernel library unless a build of these exact sources exists.

    Writes to per-process temporary names and renames the library into place,
    so two processes building at once never load a half-written file. The
    compiler's register/shared-memory report (``-Xptxas -v``) is kept beside
    the library as ``<name>.log``."""
    lib = library_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    tmp = BUILD_DIR / f"{tag}.tmp"
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for obj, src in zip(objs, _sources())])
        log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.ilvlm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ilvlm_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def kernel(name: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """The C entry ``name`` of the kernel library, with its signature set."""
    fn = getattr(load_library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(status: int, name: str) -> None:
    """Raise if a kernel entry reported a CUDA error for its launch."""
    if status != 0:
        msg = load_library().ilvlm_cuda_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} at launch: {msg}")
