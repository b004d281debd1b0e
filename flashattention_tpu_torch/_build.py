"""Build and load the port's native code: the CUDA kernels and the allocator.

Each ``csrc/<name>.cu`` of this package compiles on its own into
``_build/lib<name>.so`` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>.so csrc/<name>.cu

and is loaded with ``ctypes``. The sources have a plain C interface and do
not include PyTorch's headers, so a build takes seconds. Pointers pass as
``c_void_p`` (``tensor.data_ptr()``), the stream as
``torch.cuda.current_stream().cuda_stream``. Every C entry point returns
``cudaGetLastError()`` after its launch; :func:`check` raises on a nonzero
value, so a refused launch never passes silently.

The page allocator (``csrc/page_allocator.cc`` at the repository root) and
the tokenizer's BPE merge engine (``csrc/bpe_encoder.cc``) are built with
g++ into the same ``_build`` directory, never through that directory's
Makefile, whose output belongs to the JAX package.

A library is rebuilt when its source, or a ``csrc/*.cuh`` header, is newer
than the built file. Builds write to a temporary name and rename it into
place, so processes that build at the same time never load a half-written
file.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ALLOCATOR_SRC = PKG_DIR.parent / "csrc" / "page_allocator.cc"
BPE_SRC = PKG_DIR.parent / "csrc" / "bpe_encoder.cc"

KERNELS = ("paged_attention", "paged_append", "flash_fwd", "flash_bwd",
           "flash_fwd_fp8", "sparse_fwd", "sparse_bwd")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# ptxas register / shared-memory report of each kernel build in this process.
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _stale(out: Path, src: Path) -> bool:
    """Missing, or older than its source or a shared header beside it."""
    if not out.exists():
        return True
    newest = max(p.stat().st_mtime
                 for p in [src, *src.parent.glob("*.cuh")])
    return out.stat().st_mtime < newest


def _compile(cmd_prefix: list[str], src: Path, out: Path) -> str:
    """Compile ``src`` into ``out`` atomically; returns the compiler's
    stderr (ptxas report). Raises with the compiler output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            cmd_prefix + ["-o", tmp, str(src)],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {src.name} failed:\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
        return proc.stderr
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def kernel_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_kernel(name: str) -> float:
    """Build one kernel library if it is missing or stale; seconds taken."""
    src = CSRC_DIR / f"{name}.cu"
    out = kernel_path(name)
    t0 = time.perf_counter()
    if _stale(out, src):
        BUILD_LOG[name] = _compile([_nvcc()] + NVCC_FLAGS, src, out)
    return time.perf_counter() - t0


def build_all() -> dict[str, float]:
    """Build every kernel library, one nvcc per source, all at once."""
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        futures = {name: pool.submit(build_kernel, name) for name in KERNELS}
        return {name: f.result() for name, f in futures.items()}


def load_kernel(name: str, declare) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use;
    ``declare(lib)`` sets its entry points' argtypes and restype."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_kernel(name)
            lib = ctypes.CDLL(str(kernel_path(name)))
            declare(lib)
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _build_host(src: Path, out: Path, what: str) -> Path:
    """``src`` (standard C++ only) built with g++ into ``out`` if missing or
    stale; raises where g++ is missing or the build fails."""
    if _stale(out, src):
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found: {what} cannot be built")
        _compile([gxx, "-O2", "-fPIC", "-std=c++17", "-shared"], src, out)
    return out


def build_allocator() -> Path:
    """The allocator's shared library, built with g++ if missing or stale."""
    return _build_host(ALLOCATOR_SRC, BUILD_DIR / "libfat_allocator.so",
                       "the allocator")


def build_bpe() -> Path:
    """The tokenizer's BPE merge engine, built with g++ if missing or
    stale."""
    return _build_host(BPE_SRC, BUILD_DIR / "libfat_bpe.so",
                       "the BPE engine")
