"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all at once, and the objects are linked into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes). The library lands in ``build/dfac_tpu_torch/``
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> launches since the last reset. conv_probe counts K6/K9
# (stage 13's g-k), conv1_pass K7 (stage 11's v0-v4), conv_forms K8
# (stage 12's a, c, d, f), conv_chunked K10 (stage 14's h2, i2, j2),
# conv_trailing K11 (stage 15's j3, j4, j5, c2); the five share
# csrc/conv_probe.cu; conv_block_w8a8 counts the w8a8 chain's int8 blocks
# and block1_w8a8 its block 1 (both csrc/conv_block_w8a8.cu, no Pallas
# counterpart).
LAUNCHES = {"gemm_frontend": 0, "conv_block": 0, "fb_log_dct": 0, "time_pool": 0, "conv_probe": 0,
            "conv1_pass": 0, "conv_forms": 0, "conv_chunked": 0, "conv_trailing": 0, "conv_block_w8a8": 0,
            "block1_w8a8": 0}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    # wave, basis, fb, fb_lo, fb_hi, dct, out, n_utt, n_samples, n_frames,
    # log_floor, bf16, stream
    "dfac_gemm_frontend": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # x, w, b, out, batch, h, w, c_in, c_out, pool, bf16, stream
    "dfac_conv_block": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # power, fb, fb_lo, fb_hi, dct, out, rows, log_floor, stream
    "dfac_fb_log_dct": [_P, _P, _P, _P, _P, _P, _I, _F, _P],
    # x, out, batch, t_in, row (F * C), tt, bf16, stream
    "dfac_time_pool": [_P, _P, _I, _I, _I, _I, _I, _P],
    # case, in, w, out, y (or null), done, batch, t_in, f_in, rows, cols, n_out, stream
    "dfac_conv_probe": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # case, in, w, out, y (or null), done, batch, t_in, f_in, n_out, group, stream
    "dfac_conv_pass": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # case, in, w, out, y (or null), done, batch, t_in, f_in, rows, cols, win, n_out, stream
    "dfac_conv_chunk": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, wt, deq, b, inv_s, mode (0 f32, 1 pooled, 2 mean), out, batch, h, w, c_in, c_out, stream
    "dfac_conv_block_w8a8": [_P, _P, _P, _P, _F, _I, _P, _I, _I, _I, _I, _I, _P],
    "dfac_conv_block_w8a8_smem": [_I, _I],
    # x, w, b, inv_s, out, batch, t, f, x's strides (b, t, f), bf16, stream
    "dfac_block1_w8a8": [_P, _P, _P, _F, _P, _I, _I, _I, _L, _L, _L, _I, _P],
    # dynamic shared memory per block, bytes: (bf16), (c_in, c_out, bf16), (),
    # (case, f_in, cols, n_out), (case, f_in, n_out), (case, f_in, cols, n_out)
    "dfac_gemm_frontend_smem": [_I],
    "dfac_conv_block_smem": [_I, _I, _I],
    "dfac_fb_log_dct_smem": [],
    # the post-FFT kernel's walk: rows per tile, ring slots, padded band
    # width, blocks of a launch of (rows)
    "dfac_fb_log_dct_tile_rows": [],
    "dfac_fb_log_dct_stages": [],
    "dfac_fb_log_dct_band": [],
    "dfac_fb_log_dct_grid": [_I],
    "dfac_conv_probe_smem": [_I, _I, _I, _I],
    "dfac_conv_pass_smem": [_I, _I, _I],
    "dfac_conv_chunk_smem": [_I, _I, _I, _I],
}

_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """Launches per kernel since ``before`` (an earlier :func:`launch_counts`)."""
    return {k: n - before[k] for k, n in LAUNCHES.items()}


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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{s.stem}.o" for s in _sources() if s.suffix == ".cu"]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(SRC_DIR / f"{o.stem}.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for o in objs
        ]
        logs = [p.communicate()[0] for p in procs]  # waits for every compile
        failed = [(o.stem, p.returncode, log) for o, p, log in zip(objs, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(f"{n}.cu ({rc}):\n{log}" for n, rc, log in failed))
        lib = Path(tmp) / out.name
        proc = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}")
        out.with_suffix(".ptxas.txt").write_text("".join(logs))
        os.replace(lib, out)  # atomic: a concurrent loader never sees half a file
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
