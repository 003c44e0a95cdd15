"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes). The library lands in ``build/dfac_tpu_torch/``
at the root of the checkout, named by a hash of the sources and flags, and
is reused while that hash is unchanged. ``ptxas -v`` output (registers,
shared memory, spills per kernel) is kept beside it.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.

Each C entry point returns ``cudaGetLastError()`` after its launch, so a
refused launch (too many threads, too much shared memory) raises here
instead of vanishing. The launch counters live here too: each kernel
wrapper adds one where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "dfac_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> launches since the last reset
LAUNCHES = {"gemm_frontend": 0, "conv_block": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # wave, basis, fb, fb_lo, fb_hi, dct, out, n_utt, n_samples, n_frames,
    # log_floor, bf16, stream
    "dfac_gemm_frontend": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # x, w, b, out, batch, h, w, c_in, c_out, pool, bf16, stream
    "dfac_conv_block": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # dynamic shared memory per block, bytes: (bf16) and (c_in, c_out, bf16)
    "dfac_gemm_frontend_smem": [_I],
    "dfac_conv_block_smem": [_I, _I, _I],
}

_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library for these sources exists;
    return its path. Raises with nvcc's output when the build fails."""
    out = BUILD_DIR / f"libdfac_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}")
    out.with_suffix(".ptxas.txt").write_text(proc.stdout)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def ptxas_report() -> str:
    """``ptxas -v`` lines of the current build ('' if it was built elsewhere)."""
    path = build().with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.dfac_error_string.argtypes = [ctypes.c_int]
        lib.dfac_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().dfac_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
