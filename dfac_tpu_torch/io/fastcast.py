"""Host-side ingest casts: bf16 cast, int8 quantization and row gathers.

Counterpart of :mod:`dfac_tpu.io.fastcast`, with the same functions,
signatures and errors. The JAX package runs these through a native
thread pool (``fastcast.cpp``) with a numpy fallback; here they are
torch's CPU ops, which ATen runs over its intra-op thread pool, and the
results are CPU tensors. Every output equals the JAX package's bit for
bit (``tests/test_torch_port_fastcast.py``):

* the bf16 cast is round-to-nearest-even (torch's ``float -> bfloat16``,
  as ``ml_dtypes``), and a NaN becomes the canonical quiet NaN of its sign
  (``0x7fc0``), as ``fastcast.cpp`` and ``ml_dtypes`` make it (torch's
  vectorized cast gives ``0xffff``);
* :func:`quant_i8` takes, per group of the last axis, ``scale = amax /
  127`` as an f32 divide (1.0 for an all-zero group), then ``q =
  round(a / scale)`` as an f32 divide and a round half to even
  (``torch.round``, as ``np.rint``), clipped to +-127.

``threads`` sets ATen's intra-op thread count for the call (a process-wide
setting, restored after it); None keeps the current one.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

# A memory-mapped store is read-only; these functions only read the tensor over it.
warnings.filterwarnings(
    "ignore", message="The given NumPy array is not writable", category=UserWarning, module=__name__
)


@contextlib.contextmanager
def _threads(n: int | None):
    if n is None:
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, int(n)))
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))


def _checked_idx(idx, n_rows: int) -> np.ndarray:
    """Gather indices as contiguous int64, refusing any outside ``[0,
    n_rows)`` with the JAX package's error (negative indices included)."""
    idx64 = np.ascontiguousarray(np.asarray(idx, dtype=np.int64))
    if len(idx64) and (idx64.min() < 0 or idx64.max() >= n_rows):
        bad = idx64[(idx64 < 0) | (idx64 >= n_rows)][0]
        raise IndexError(
            f"gather index {bad} out of bounds for {n_rows} rows "
            "(negative indices are not supported on the native path)"
        )
    return idx64


def _gather(src, idx) -> torch.Tensor:
    src = np.asarray(src) if not isinstance(src, torch.Tensor) else src
    rows = torch.from_numpy(_checked_idx(idx, len(src)))
    return torch.index_select(_tensor(src), 0, rows)


def _bf16(a: torch.Tensor) -> torch.Tensor:
    out = a.to(torch.bfloat16)
    nan = torch.isnan(out)  # only a NaN casts to NaN; the bf16 copy is half the bytes to scan
    if nan.any():
        quiet = torch.where(torch.signbit(a[nan]), -64, 0x7FC0).to(torch.int16)  # 0xffc0 / 0x7fc0
        out.view(torch.int16)[nan] = quiet
    return out


def cast_bf16(arr, threads: int | None = None) -> torch.Tensor:
    """f32 array (a memmap view too) -> bf16 CPU tensor, round to nearest even."""
    with _threads(threads):
        return _bf16(_tensor(arr))


def gather_cast_bf16(src, idx, threads: int | None = None) -> torch.Tensor:
    """``bf16(src[idx])``: ``src`` is (N, ...) f32 (typically the
    memory-mapped corpus), ``idx`` row indices in ``[0, N)``."""
    with _threads(threads):
        return _bf16(_gather(src, idx))


def _quant(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    a = a.float()
    lo, hi = torch.aminmax(a, dim=-1)  # one read, no |a| temporary
    amax = torch.maximum(hi, -lo)
    scales = torch.where(amax > 0, amax / 127.0, torch.ones((), dtype=torch.float32))
    q = torch.div(a, scales[..., None])
    q = q.round_().clamp_(-127, 127).to(torch.int8)
    return q, scales


def quant_i8(arr, threads: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-group int8 quantization of feature rows.

    ``arr`` is (..., G) float32 (typically (B, F, T): each feature dim's T
    frames form one scale group); returns ``(q, scales)``, ``q`` int8 of
    ``arr``'s shape and ``scales`` f32 of shape ``arr.shape[:-1]``, with
    ``q * scales[..., None] ~= arr``. Groups whose max-abs is 0 get scale
    1.0. Half the host -> device bytes of bf16 (``predict --fast
    --ingest-int8``)."""
    with _threads(threads):
        return _quant(_tensor(arr))


def gather_quant_i8(src, idx, threads: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``quant_i8(src[idx])``: ``src`` is (N, G, T) f32; returns ``(q
    (len(idx), G, T) int8, scales (len(idx), G) f32)``."""
    with _threads(threads):
        return _quant(_gather(src, idx))


def gather_f32(src, idx, threads: int | None = None) -> torch.Tensor:
    """``src[idx]`` as an f32 CPU tensor (the f32 ingest's gather)."""
    with _threads(threads):
        return _gather(src, idx).float()
