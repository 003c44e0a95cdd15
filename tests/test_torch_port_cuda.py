"""The port's CUDA kernels against their plain versions, at edge-case shapes.

Marked ``cuda``: every test needs an NVIDIA GPU with ``nvcc`` and skips
elsewhere (the kernels have no CPU mode). ``chip_smoke.py`` checks the
serving shapes; these check the edges (odd H with and without the pool, W
not a multiple of a warpgroup's 32-column tile or of a warp's 8 columns,
tiny H and T, fewer tiles than SMs, enough tiles that each tile ring
wraps, every kernel case of the conv block, block 1's 16-pixel tiles
across rows and utterances, the f32 kernel's 36-column and row tiles
ragged and whole, f32, misaligned inputs, a second call equal
bit for bit; for the post-FFT kernel one row, rows off its 32-row tile,
lead dims, the log floor, huge power, misaligned and non-contiguous power,
blocks that walk 1, 2 and many tiles with a ring that wraps and a ragged
last tile, power 4, 8 and 12 bytes past a 16-byte boundary bit for bit,
one row alone as in a 41,088-row batch; for the time pool odd T, f32, rows
that are not 16-byte vectors, misaligned, transposed and untileable inputs; for the
conv-probe checksums each case at B=1 and B=3 with every output, the wrap
columns included, against the plain version; for stages 11 and 12's cases
odd T, F that is not a multiple of 8 (v1's and d's ragged last quad), batches
that are not multiples of v3's group of 8, every output against the plain
version; for stages 14 and 15's cases every output at small odd sizes,
F not a multiple of 8, h2's clamped second window, c2's partly and wholly
clamped last chunks and chunks longer than a block, j5 at 64 -> 128
channels, and at the stages' own widths at B=2; for the w8a8 int8 block
its three modes (int8 pooled, f32, the mean over time) bit for bit at odd
H, W not a multiple of its 32-column tile, B=1, saturating codes, C_in 32
and 64 (blocks 2 and 3), fewer tiles than SMs, more tiles than a wave,
misaligned input, a second call equal to the first; for the w8a8 block-1
kernel, f32 bit for bit and bf16 within one code step at <= 0.1% of
positions, at the serving shape, odd T, F off a unit, B=1, the chain's
transposed view and a storage offset, saturating codes, a second call
equal; the w8a8 chain's 3 launches a batch). On the card, without the JAX
package's conftest (this file imports no JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dfac_tpu_torch.features.lfcc import LFCCConfig
from dfac_tpu_torch.ops import _build
from dfac_tpu_torch.ops import conv_block as tcb
from dfac_tpu_torch.ops import conv_probe
from dfac_tpu_torch.ops.conv_block import fused_conv_block, reference_conv_block
from dfac_tpu_torch.ops.conv_block_w8a8 import block1_w8a8, conv_block_w8a8, reference_block1_w8a8, \
    reference_conv_block_w8a8
from dfac_tpu_torch.ops.gemm_frontend import cepstra_plain, gemm_lfcc_cepstra
from dfac_tpu_torch.ops.lfcc_kernel import fb_log_dct_plain, fused_fb_log_dct
from dfac_tpu_torch.ops.pool import time_pool, time_pool_plain

pytestmark = pytest.mark.cuda
CFG = LFCCConfig()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close_bf16_last_bit(got, want):
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= 2.0**-7 * torch.maximum(g.abs(), w.abs()) + 1e-4).all())


FRONTEND_CASES = [
    ((1,), 1), ((3,), 17), ((2, 3), 64),
    ((1,), 127), ((1,), 128), ((1,), 129),  # the bf16 kernel's 128-frame tile edges
    ((3,), 43),     # tiles that straddle utterances
    ((160,), 321),  # 402 bf16 tiles, 803 f32 tiles: each block walks >= 3 tiles, so the basis ring wraps
]


@pytest.mark.parametrize("lead,frames", FRONTEND_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_frontend_kernel_matches_plain(cuda, lead, frames, dtype):
    gen = torch.Generator().manual_seed(frames)
    # a ragged tail: rows of num_samples + 37 samples, so most rows are not 16-byte aligned
    wave = torch.randn(*lead, CFG.num_samples(frames) + 37, generator=gen).to(cuda)
    before = _build.launch_counts()["gemm_frontend"]
    got = gemm_lfcc_cepstra(wave, CFG, dtype)
    want = cepstra_plain(wave, CFG, dtype)
    torch.cuda.synchronize()
    assert _build.launch_counts()["gemm_frontend"] == before + 1
    assert torch.equal(gemm_lfcc_cepstra(wave, CFG, dtype), got)  # a second call repeats bit for bit
    assert got.shape == want.shape == (*lead, frames, CFG.n_ceps)
    # same operands; f32 summation order only (chip_smoke.py's K1 bound)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


CONV_CASES = [
    (1, 33, 70, 32, 64, True),     # tensor cores, odd H pooled, ragged last column tile
    (2, 33, 70, 64, 128, False),   # tensor cores, odd H unpooled: masked last row
    (2, 2, 5, 32, 64, True),       # one pooled row, one narrow tile
    (1, 5, 130, 1, 32, False),     # Cin = 1 kernel, unpooled
    (2, 7, 9, 1, 8, True),         # Cin = 1 kernel, odd H pooled
    (2, 9, 20, 8, 16, True),       # generic direct kernel
    # the tensor-core kernel's tile geometry, for blocks 2 (32 -> 64, pooled)
    # and 3 (64 -> 128, unpooled): a warpgroup's tile is 2 conv rows x 32
    # columns, a warp's 8 of them
    *((2, h, w, cin, cout, pool) for cin, cout, pool, h in ((32, 64, True, 6), (64, 128, False, 5))
      for w in (31, 32, 33, 65, 180)),  # ragged warpgroup and block tiles
    *((2, h, 70, cin, cout, True) for cin, cout in ((32, 64), (64, 128)) for h in (2, 3)),  # 1 pooled row
    (1, 4, 20, 32, 64, True),      # fewer tiles than SMs: most blocks get none
    (1, 4, 20, 64, 128, False),
    (6, 160, 180, 32, 64, True),   # > 3 tiles per warpgroup at 2 blocks per SM: its 3-stage ring wraps
    (4, 80, 180, 64, 128, False),  # > 2 tiles per warpgroup at 1 block per SM: its 2-stage ring wraps
    # block 1's tensor-core kernel (bf16, Cin = 1, Cout = 32, pooled; in f32
    # conv_block_cin1_f32, units of two adjacent pixels of a row): each warp
    # walks tiles of 16 pixels of the flat (b, ho, col) output
    *((2, h, w, 1, 32, True) for w in (1, 63, 64, 65, 180) for h in (2, 3)),  # W ragged or whole; 1 pooled row
    (3, 9, 7, 1, 32, True),        # tiles straddle rows (W = 7) and utterances (28 pixels each)
    (5, 4, 3, 1, 32, True),        # 6 pixels per utterance: a tile spans three; the last tile is partial
    (48, 161, 180, 1, 32, True),   # ~5 trips of 4 tiles per warp at 2 blocks per SM: the loop walks several
]


# the f32 kernel of blocks 2 and 3 (conv_block_f32): a tile is 2 * RP conv
# rows x 36 columns (RP = 4 row pairs at 32 -> 64, 2 at 64 -> 128); Cout is
# not split across blocks. Block 1 in f32 (conv_block_cin1_f32) works on
# units of two adjacent pixels of a row.
F32_CASES = [
    # ragged and whole column tiles; 5 pooled rows: a ragged row tile
    *((2, 10, w, 32, 64, True) for w in (35, 36, 37, 72)),
    # the same at block 3; odd H: 3 row pairs, the last row masked
    *((2, 5, w, 64, 128, False) for w in (35, 36, 37, 72)),
    (2, 2, 40, 32, 64, True), (2, 3, 40, 32, 64, True),      # one pooled row
    (2, 1, 40, 64, 128, False),                              # one conv row
    (1, 8, 36, 32, 64, True), (1, 4, 36, 64, 128, False),    # one tile: fewer tiles than SMs
    (16, 160, 180, 32, 64, True),   # 1,600 tiles, ~12 per block: the halo stages and the weight ring wrap
    (16, 80, 180, 64, 128, False),
    (2, 5, 1, 1, 32, True), (2, 4, 2, 1, 32, True), (3, 6, 5, 1, 32, True),  # block 1: a unit's second pixel masked
]


@pytest.mark.parametrize(
    "b,h,w,cin,cout,pool,dtype",
    [(*c, dt) for dt in (torch.bfloat16, torch.float32) for c in CONV_CASES] + [(*c, torch.float32) for c in F32_CASES],
)
def test_conv_block_kernel_matches_plain(cuda, b, h, w, cin, cout, pool, dtype):
    gen = torch.Generator().manual_seed(h * w + cin)
    x = torch.randn(b, h, w, cin, generator=gen).to(cuda, dtype)
    wk = (torch.randn(3, 3, cin, cout, generator=gen) * (2.0 / (9 * cin)) ** 0.5).to(cuda)
    bias = (torch.randn(cout, generator=gen) * 0.1).to(cuda)
    before = _build.launch_counts()["conv_block"]
    got = fused_conv_block(x, wk, bias, pool)
    want = reference_conv_block(x, wk, bias, pool)
    torch.cuda.synchronize()
    assert _build.launch_counts()["conv_block"] == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(fused_conv_block(x, wk, bias, pool), got)  # a second call repeats bit for bit
    if dtype == torch.bfloat16:
        assert _close_bf16_last_bit(got, want)  # sums rounded to bf16 in other orders
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)  # f32 order only


@pytest.mark.parametrize("cin,cout,pool,dtype", [(32, 64, True, torch.bfloat16), (32, 64, True, torch.float32),
                                                  (64, 128, False, torch.float32), (1, 32, True, torch.float32)])
def test_conv_block_misaligned_input(cuda, cin, cout, pool, dtype):
    gen = torch.Generator().manual_seed(cin)
    flat = torch.randn(1 + 2 * 6 * 70 * cin, generator=gen).to(cuda, dtype)
    x = flat[1:].view(2, 6, 70, cin)  # data pointer one element past an aligned one
    wk = torch.randn(3, 3, cin, cout, generator=gen).to(cuda) * 0.1
    bias = (torch.randn(cout, generator=gen) * 0.1).to(cuda)
    got = fused_conv_block(x, wk, bias, pool)
    torch.testing.assert_close(got, fused_conv_block(x.clone(), wk, bias, pool), atol=0, rtol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(got, reference_conv_block(x, wk, bias, pool), atol=1e-4, rtol=1e-4)


def test_conv_block_cin1_misaligned_input(cuda):
    gen = torch.Generator().manual_seed(2)
    flat = torch.randn(1 + 2 * 7 * 65, generator=gen).to(cuda, torch.bfloat16)
    x = flat[1:].view(2, 7, 65, 1)  # data pointer 2 bytes past an aligned one
    wk = torch.randn(3, 3, 1, 32, generator=gen).to(cuda) * 0.4
    bias = torch.randn(32, generator=gen).to(cuda) * 0.1
    got = fused_conv_block(x, wk, bias, True)
    torch.testing.assert_close(got, fused_conv_block(x.clone(), wk, bias, True), atol=0, rtol=0)
    assert _close_bf16_last_bit(got, reference_conv_block(x, wk, bias, True))


@pytest.mark.parametrize("cin,cout", [(32, 64), (64, 128)])
def test_f32_shared_memory_matches_tile_geometry(cuda, cin, cout):
    # the kernel's tiling constants against the host's copy of them: two
    # halo stages of (halo rows, Cin, 36 + 2 columns) f32, two weight slabs
    # of (3 dx, 32 ci, Cout) f32, four 8-byte mbarriers
    g = tcb.f32_tile_geometry(2, tcb.F32_TW, cout, True)
    want = 4 * (2 * g["halo_rows"] * cin * (tcb.F32_TW + 2) + 2 * 3 * 32 * cout) + 8 * 4
    assert _build.library().dfac_conv_block_smem(cin, cout, 0) == want


def test_conv_block_direct_splits_batches_past_2_31_outputs(cuda):
    # 2 -> 8 channels take the direct kernel, whose indices are 32-bit: 2^16
    # outputs per utterance, so 2^15 + 3 utterances need two launches
    batch, h, width = 2**15 + 3, 64, 256
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(batch, h, width, 2, device=cuda, generator=gen).to(torch.bfloat16)
    wk = torch.randn(3, 3, 2, 8, device=cuda, generator=gen) * 0.3
    bias = torch.randn(8, device=cuda, generator=gen) * 0.1
    got = fused_conv_block(x, wk, bias, True)
    assert got.numel() > 2**31
    for b in (0, 2**15 - 2, 2**15 - 1, batch - 1):  # each side of the split, and the last utterance
        assert _close_bf16_last_bit(got[b : b + 1], reference_conv_block(x[b : b + 1], wk, bias, True))


def test_conv_block_rejects_bad_shapes(cuda):
    x = torch.zeros(1, 4, 4, 2, device=cuda)
    with pytest.raises(ValueError):
        fused_conv_block(x, torch.zeros(3, 3, 3, 4, device=cuda), torch.zeros(4, device=cuda))
    with pytest.raises(ValueError):
        fused_conv_block(x, torch.zeros(3, 3, 2, 4, device=cuda), torch.zeros(5, device=cuda))


def test_serving_chain_cuda_matches_cpu(cuda):
    """The folded chain on stored (B, F, T) features: kernels on the card
    against the plain versions on the CPU, both bf16."""
    from dfac_tpu_torch.models import build_model
    from dfac_tpu_torch.models.fast_infer import cnn2d_fast_scores, fold_cnn2d

    torch.manual_seed(0)
    folded = fold_cnn2d(build_model("cnn2d", in_features=20).eval().state_dict())
    feats = torch.randn(5, 20, 33, generator=torch.Generator().manual_seed(2))
    want = cnn2d_fast_scores(folded, feats)
    got = cnn2d_fast_scores({k: v.to(cuda) for k, v in folded.items()}, feats.to(cuda))
    torch.testing.assert_close(got.cpu(), want, atol=2e-2, rtol=0)  # two bf16 chains


def _power(lead, seed, scale=100.0):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(*lead, 257, generator=gen) ** 4 * scale


@pytest.mark.parametrize("lead", [(1,), (65,), (321,), (2, 3, 17), (2, 3, 64)])
def test_fb_log_dct_kernel_matches_plain(cuda, lead):
    """One row, rows off the 32-row tile, lead dims (the tile crosses them)."""
    power = _power(lead, sum(lead)).to(cuda)
    before = _build.launch_counts()["fb_log_dct"]
    got = fused_fb_log_dct(power, CFG)
    want = fb_log_dct_plain(power, CFG)
    torch.cuda.synchronize()
    assert _build.launch_counts()["fb_log_dct"] == before + 1
    assert got.shape == want.shape == (*lead, CFG.n_ceps)
    # same f32 math; dense cuBLAS products against banded in-order sums
    # (chip_smoke.py's K4 bound, the JAX package's tests/test_lfcc.py:112)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("scale", [0.0, 1e30])
def test_fb_log_dct_kernel_extremes(cuda, scale):
    """All-zero power: every filter sits on the log floor; 1e30: energies
    near 1e30, far from overflow."""
    from dfac_tpu_torch.features.lfcc import device_constants

    power = (_power((100,), 3) * scale).to(cuda)
    got = fused_fb_log_dct(power, CFG)
    want = fb_log_dct_plain(power, CFG)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    # f32 sums of 120 terms: the rounding error scales with sum |log E * DCT|
    # (n eps of it), not with the output, and |log E| reaches 69 here
    _, fb, dct = device_constants(CFG, cuda, torch.float32)
    terms = torch.log(torch.clamp(power @ fb, min=CFG.log_floor)).abs() @ dct.abs()
    assert bool(((got - want).abs() <= 1e-4 + 120 * 2.0**-24 * terms).all())


def test_fb_log_dct_misaligned_and_strided(cuda):
    power = _power((130,), 4).to(cuda)
    flat = torch.empty(1 + power.numel(), device=cuda)
    flat[1:] = power.reshape(-1)
    shifted = flat[1:].view(130, 257)  # data pointer 4 bytes past a 16-byte boundary
    torch.testing.assert_close(fused_fb_log_dct(shifted, CFG), fused_fb_log_dct(power, CFG), atol=0, rtol=0)
    wide = torch.zeros(130, 300, device=cuda)
    wide[:, :257] = power
    with pytest.raises(ValueError, match="contiguous"):
        fused_fb_log_dct(wide[:, :257], CFG)
    with pytest.raises(ValueError, match="257 bins"):
        fused_fb_log_dct(wide, CFG)
    with pytest.raises(TypeError, match="float32"):
        fused_fb_log_dct(power.double(), CFG)


def _fb_log_dct_walk():
    """(rows per tile, ring slots, blocks of a full card) of the kernel's walk."""
    lib = _build.library()
    tile = lib.dfac_fb_log_dct_tile_rows()
    return tile, lib.dfac_fb_log_dct_stages(), lib.dfac_fb_log_dct_grid(1 << 30)


# (tiles per block of a full card, rows past them): blocks walk 1, 2, a ring's
# worth and more tiles, the ring wraps, the last tile is one row or one short
WALK_CASES = [(1, -1), (1, 1), (2, -1), (2, 1), ("stages", -1), ("stages", 1), ("stages+1", 1), (7, -1), (7, 5)]


@pytest.mark.parametrize("per_block,extra", WALK_CASES)
def test_fb_log_dct_walk_matches_plain(cuda, per_block, extra):
    tile, stages, grid = _fb_log_dct_walk()
    per_block = {"stages": stages, "stages+1": stages + 1}.get(per_block, per_block)
    rows = grid * per_block * tile + extra
    assert _build.library().dfac_fb_log_dct_grid(rows) == grid
    power = _power((rows,), rows).to(cuda)
    got = fused_fb_log_dct(power, CFG)
    want = fb_log_dct_plain(power, CFG)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)  # as test_fb_log_dct_kernel_matches_plain


@pytest.mark.parametrize("rows", [1, 5, 33, 70])
def test_fb_log_dct_fewer_tiles_than_blocks(cuda, rows):
    tile, _, grid = _fb_log_dct_walk()
    assert _build.library().dfac_fb_log_dct_grid(rows) == min(grid, -(-rows // tile))
    power = _power((rows,), rows + 1).to(cuda)
    torch.testing.assert_close(fused_fb_log_dct(power, CFG), fb_log_dct_plain(power, CFG), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("offset", [4, 8, 12])
def test_fb_log_dct_source_offsets_bit_for_bit(cuda, offset):
    """Power 4, 8 or 12 bytes past a 16-byte boundary, over 2 tiles a block
    and 3 rows: the tensor ends 0-3 floats past its last 16-byte boundary."""
    tile, _, grid = _fb_log_dct_walk()
    rows = 2 * grid * tile + 3
    power = _power((rows,), offset).to(cuda)
    flat = torch.empty(offset // 4 + power.numel(), device=cuda)
    flat[offset // 4:] = power.reshape(-1)
    shifted = flat[offset // 4:].view(rows, 257)
    assert shifted.data_ptr() % 16 == offset
    torch.testing.assert_close(fused_fb_log_dct(shifted, CFG), fused_fb_log_dct(power, CFG), atol=0, rtol=0)


def test_fb_log_dct_row_alone_equals_row_in_batch(cuda):
    """One row alone gives the bits it gets inside a 41,088-row batch (B=128 x
    321 frames), wherever it lies in its tile."""
    power = _power((128 * 321,), 6).to(cuda)
    batch = fused_fb_log_dct(power, CFG)
    for i in (0, 31, 32, 20_000, 128 * 321 - 1):
        assert torch.equal(fused_fb_log_dct(power[i : i + 1], CFG), batch[i : i + 1]), i


def test_fb_log_dct_band_fits_the_filterbank(cuda):
    """The kernel pads every filter to a fixed band: the widest band of the
    filterbank it is given must fit."""
    from dfac_tpu_torch.features.lfcc import banded_constants

    _, fb_lo, fb_hi, _ = banded_constants(CFG, cuda)
    assert int((fb_hi - fb_lo).max()) + 1 <= _build.library().dfac_fb_log_dct_band()


@pytest.mark.parametrize("method,kernel", [("gemm", "gemm_frontend"), ("fft-pallas", "fb_log_dct"), ("fft", None)])
def test_batch_driver_cuda_matches_cpu(cuda, method, kernel):
    """The extraction driver on the card against its CPU run (plain
    versions), with one launch of the method's kernel per batch."""
    from dfac_tpu_torch.features.lfcc import lfcc_features_batch

    waves = torch.randn(5, CFG.num_samples(33), generator=torch.Generator().manual_seed(5)).numpy()
    _build.reset_launch_counts()
    got = lfcc_features_batch(waves, CFG, batch_size=2, method=method, device="cuda")
    counts = _build.launch_counts()
    assert counts == {k: (3 if k == kernel else 0) for k in counts}
    want = lfcc_features_batch(waves, CFG, batch_size=2, method=method, device="cpu")
    assert got.shape == want.shape == (5, 180, 33)
    # K1's bound (chip_smoke.py) covers both kernels; the deltas add sums of
    # five scaled terms
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("shape,tt", [((3, 33, 180, 32), 16), ((2, 64, 7, 3), 8), ((1, 321, 180, 64), 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_time_pool_kernel_matches_plain(cuda, shape, tt, dtype):
    """Odd T (the last row is dropped), and rows of 21 elements that are not
    16-byte vectors (the kernel's scalar path)."""
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(sum(shape))).to(cuda, dtype)
    before = _build.launch_counts()["time_pool"]
    got = time_pool(x, tt)
    want = time_pool_plain(x)
    torch.cuda.synchronize()
    assert _build.launch_counts()["time_pool"] == before + 1
    assert got.shape == want.shape == (shape[0], shape[1] // 2, *shape[2:]) and got.dtype == dtype
    assert torch.equal(got, want)  # one rounding of the sum, an exact halving: bit for bit


def test_time_pool_kernel_input_layouts(cuda):
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 32, 180, 32, generator=gen).to(cuda, torch.bfloat16)
    flat = torch.empty(1 + x.numel(), device=cuda, dtype=torch.bfloat16)
    flat[1:] = x.reshape(-1)
    shifted = flat[1:].view_as(x)  # data pointer 2 bytes past a 16-byte boundary
    assert torch.equal(time_pool(shifted), time_pool_plain(x))
    transposed = x.transpose(2, 3)  # (B, T, C, F) view of the same memory
    with pytest.raises(ValueError, match="contiguous"):
        time_pool(transposed)
    assert torch.equal(time_pool(transposed.contiguous()), time_pool_plain(transposed))
    with pytest.raises(ValueError, match="multiple of the tile"):
        time_pool(x[:1, :30], tt=16)  # T // 2 = 15
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        time_pool(x.half())


def _probe_inputs(batch, device, seed):
    from dfac_tpu_torch.scripts.train_opt_probe import stage13_inputs

    return stage13_inputs(batch, torch.bfloat16, device, seed)


# conv2_checksum's geometries beyond stage 13's own (160 rows, j's 176 and k's
# 192 columns at B = 1, 3): more tiles than the persistent grid takes at once
# (B = 133), and odd rows with column tails (9 rows; j 37, k 45 columns)
RAGGED_CONV2 = {"CONV2_ROWS": 9, "CONV2_SLICE_COLS": 37}
PROBE_PARAMS = ([(name, batch, None) for batch in (1, 3) for name in conv_probe.CASES]
                + [(name, 133, geom) for name in "jk" for geom in (None, "ragged")])


@pytest.mark.parametrize("name,batch,geom", PROBE_PARAMS)
def test_conv_probe_kernel_matches_plain(cuda, name, batch, geom, monkeypatch):
    """Every output y at stage 13's shapes (or the ragged conv2 geometry),
    the wrap columns 0 and Fp - 1 (roll cases) element by element, and the
    checksum within the bound."""
    case = conv_probe.CASES[name]
    arrs = _probe_inputs(batch, cuda, seed=batch)
    if geom == "ragged":
        for const, value in RAGGED_CONV2.items():
            monkeypatch.setattr(conv_probe, const, value)
        arrs["h1"] = arrs["h1"][:, :11, :45].contiguous()
    inp, w = case.inp, case.weights
    fn = {"g": lambda a, b: conv_probe.conv1_taps_checksum(a, b, "roll", return_y=True),
          "h": lambda a, b: conv_probe.conv1_taps_checksum(a, b, "slice", return_y=True),
          "i": lambda a, b: conv_probe.patches_checksum(a, b, return_y=True),
          "j": lambda a, b: conv_probe.conv2_checksum(a, b, "slice", return_y=True),
          "k": lambda a, b: conv_probe.conv2_checksum(a, b, "roll", return_y=True)}[name]
    before = _build.launch_counts()["conv_probe"]
    out, y = fn(arrs[inp], arrs[w])
    want_y = case.plain(arrs[inp], arrs[w])
    torch.cuda.synchronize()
    assert _build.launch_counts()["conv_probe"] == before + 1
    assert y.shape == want_y.shape and out.shape == (batch, 8, 128)
    # exact bf16 products; f32 sums of 9 (conv1) or 288 (conv2) terms in another order
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-5)
    for col in (0, y.shape[2] - 1):
        torch.testing.assert_close(y[:, :, col], want_y[:, :, col], atol=1e-4, rtol=1e-5)
    assert torch.equal(out, out[:, :1, :1].expand_as(out))
    bound = 1e-5 * want_y.double().abs().sum(dim=(1, 2, 3))
    assert bool(((out[:, 0, 0].double() - want_y.double().sum(dim=(1, 2, 3))).abs() <= bound).all())
    # the checksum alone (no y) is the same kernel's sum, bit for bit
    assert torch.equal(case.kernel(arrs[inp], arrs[w]), out)


def test_conv_probe_kernel_rejects_what_it_does_not_take(cuda, monkeypatch):
    arrs = _probe_inputs(1, cuda, seed=0)
    with pytest.raises(TypeError, match="bfloat16"):
        conv_probe.conv1_taps_checksum(arrs["x"].float(), arrs["w9"].float())
    with pytest.raises(ValueError, match="32 -> 64"):
        conv_probe.conv2_checksum(arrs["h1"], torch.zeros(9, 32, 16, device=cuda, dtype=torch.bfloat16))
    # 171 row pairs x 6 column tiles: more tiles than a sample's 1,024 result slots
    monkeypatch.setattr(conv_probe, "CONV2_ROWS", 341)
    h1 = torch.zeros(1, 343, 178, 32, device=cuda, dtype=torch.bfloat16)
    before = _build.launch_counts()
    with pytest.raises(RuntimeError, match="CUDA error"):
        conv_probe.conv2_checksum(h1, arrs["w2"])
    assert _build.launch_counts() == before


def _pass_inputs(batch, t, f, device, seed):
    """Stage 11/12 arrays at (B, T, F): x, w (3, 3, 32), w9 (its (9, 32) view),
    xpad_flat, h1 (B, T // 2 + 2, F + 2, 32), w2dx (3, 96, 64)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, t, f, generator=gen).to(device, torch.bfloat16)
    w = (torch.randn(3, 3, 32, generator=gen) * 0.1).to(device, torch.bfloat16)
    return {"x": x, "w": w, "w9": w.reshape(9, 32),
            "xpad_flat": torch.nn.functional.pad(x, (1, 1, 1, 1)).reshape(batch, 1, -1),
            "h1": torch.randn(batch, t // 2 + 2, f + 2, 32, generator=gen).to(device, torch.bfloat16),
            "w2dx": (torch.randn(3, 96, 64, generator=gen) * 0.1).to(device, torch.bfloat16)}


PASS_CASES = {**conv_probe.STAGE11_CASES, **conv_probe.STAGE12_CASES}
PASS_Y = {  # checksum case -> f(input, weights) -> (sums, y); v0 forms no y, so its plain one stands in
    "v0": lambda x, _: (conv_probe.sum_sq_checksum(x), conv_probe.sum_sq_plain(x)),
    "v1": lambda x, w: conv_probe.conv1_same_checksum(x, w, "fma", return_y=True),
    "v2": lambda x, w: conv_probe.conv1_same_checksum(x, w, "mma", return_y=True),
    "v3": lambda x, w: conv_probe.conv1_group_checksum(x, w, return_y=True),
    "a": lambda x, w: conv_probe.conv1_valid_checksum(x, w, "mma", return_y=True),
    "c": lambda x, w: conv_probe.flat_shift_checksum(x, w, return_y=True),
    "d": lambda x, w: conv_probe.conv1_valid_checksum(x, w, "fma", return_y=True),
    "f": lambda x, w: conv_probe.conv2_dx_checksum(x, w, return_y=True),
}
# B = 8 + 2, 2 * 8 + 3 and 16 * 8 + 5; odd T; F % 8 = 5, 4, 3; f's h1 (B, T // 2 + 2, F + 2, 32): 16, 160 and
# 11 rows, 21, 180 and 43 columns (not multiples of its 32-column tile), 1,330 tiles at B = 133
PASS_SHAPES = [(10, 33, 21), (19, 321, 180), (133, 22, 43)]


@pytest.mark.parametrize("name", list(PASS_Y))
@pytest.mark.parametrize("shape", PASS_SHAPES)
def test_conv_pass_kernel_matches_plain(cuda, name, shape, monkeypatch):
    """Every y of the stage 11/12 checksum cases against the plain version,
    the checksum within 1e-5 sum |y|, one launch per call, and the sums alone
    equal to the sums with y, bit for bit."""
    monkeypatch.setattr(conv_probe, "FLAT_WIDTH", shape[2] + 2)  # c's row width at this F
    arrs = _pass_inputs(*shape, cuda, seed=shape[0])
    case = PASS_CASES[name]
    inp, w = arrs[case.inp], arrs[case.weights]
    key = "conv1_pass" if name in conv_probe.STAGE11_CASES else "conv_forms"
    before = _build.launch_counts()
    out, y = PASS_Y[name](inp, w)
    want_y = case.plain(inp, w)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {**before, key: before[key] + 1}
    assert out.shape == (want_y.shape[0], 8, 128) and torch.equal(out, out[:, :1, :1].expand_as(out))
    if name != "v0":  # v0 forms no y
        assert y.shape == want_y.shape
        # exact bf16 products; f32 sums of 9 (conv1) or 288 (conv2) terms in another order
        torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-5)
    dims = tuple(range(1, want_y.dim()))
    bound = 1e-5 * want_y.double().abs().sum(dim=dims)
    assert bool(((out[:, 0, 0].double() - want_y.double().sum(dim=dims)).abs() <= bound).all())
    assert torch.equal(case.kernel(inp, w), out)


# (7, 9, 13): 364 pooled pixels, not a multiple of the kernel's 16-pixel tile or of a warp's 64-pixel trip
@pytest.mark.parametrize("shape", PASS_SHAPES + [(3, 8, 16), (2, 1, 9), (7, 9, 13)])
def test_conv_emit_kernel_matches_plain(cuda, shape):
    """v4 within one bf16 last bit of its plain version (odd T: the last conv
    row is dropped; T = 1: no pooled row, no launch), bit for bit twice."""
    arrs = _pass_inputs(*shape, cuda, seed=shape[1])
    before = _build.launch_counts()["conv1_pass"]
    got = conv_probe.conv1_emit(arrs["x"], arrs["w"])
    want = conv_probe.conv1_emit_plain(arrs["x"], arrs["w"])
    torch.cuda.synchronize()
    assert _build.launch_counts()["conv1_pass"] == before + (shape[1] >= 2)
    assert got.shape == want.shape == (shape[0], shape[1] // 2, shape[2], 32) and got.dtype == torch.bfloat16
    assert _close_bf16_last_bit(got, want)
    assert torch.equal(conv_probe.conv1_emit(arrs["x"], arrs["w"]), got)


def test_conv_pass_group_tail(cuda):
    """v3 below one group: an empty result and no launch; a tail past the
    last group is not read."""
    arrs = _pass_inputs(12, 9, 13, cuda, seed=3)
    before = _build.launch_counts()["conv1_pass"]
    assert conv_probe.conv1_group_checksum(arrs["x"][:7], arrs["w"]).shape == (0, 8, 128)
    assert _build.launch_counts()["conv1_pass"] == before
    tail = arrs["x"].clone()
    tail[8:] = 1e4
    assert torch.equal(conv_probe.conv1_group_checksum(tail, arrs["w"]),
                       conv_probe.conv1_group_checksum(arrs["x"], arrs["w"]))


def test_conv_pass_kernel_rejects_what_it_does_not_take(cuda, monkeypatch):
    monkeypatch.setattr(conv_probe, "FLAT_WIDTH", 15)  # xpad_flat's row width at F = 13
    arrs = _pass_inputs(2, 9, 13, cuda, seed=0)
    x, w, w9 = arrs["x"], arrs["w"], arrs["w9"]
    with pytest.raises(TypeError, match="bfloat16"):
        conv_probe.conv1_same_checksum(x.float(), w.float(), "mma")
    with pytest.raises(TypeError, match="bfloat16"):
        conv_probe.sum_sq_checksum(x.half())
    with pytest.raises(ValueError, match="32 output channels"):
        conv_probe.conv1_valid_checksum(x, w9[:, :16], "mma")
    with pytest.raises(ValueError, match="32 output channels"):
        conv_probe.flat_shift_checksum(arrs["xpad_flat"], w9[:, :16])
    with pytest.raises(ValueError, match="32 output channels"):
        conv_probe.conv1_emit(x, w[..., :16])
    with pytest.raises(ValueError, match="32 output channels"):
        conv_probe.conv1_same_checksum(x, w[..., :16], "fma")
    with pytest.raises(ValueError, match="32 output channels"):
        conv_probe.conv1_valid_checksum(x, w9[:, :16], "fma")
    with pytest.raises(ValueError, match="32 -> 64"):
        conv_probe.conv2_dx_checksum(arrs["h1"], arrs["w2dx"][..., :32])
    # f on 300 rows x 200 columns: 150 x 7 tiles, more than a sample's 1,024 result slots
    with pytest.raises(RuntimeError, match="CUDA error"):
        conv_probe.conv2_dx_checksum(torch.zeros(1, 302, 202, 32, device=cuda, dtype=torch.bfloat16), arrs["w2dx"])
    monkeypatch.setattr(conv_probe, "FLAT_WIDTH", 10 * 15)
    with pytest.raises(ValueError, match="no output"):
        conv_probe.flat_shift_checksum(arrs["xpad_flat"], w9)


CHUNK_CASES = {**conv_probe.STAGE14_CASES, **conv_probe.STAGE15_CASES}
CHUNK_Y = {  # case -> f(input, weights) -> (sums, y)
    "h2": lambda x, w: conv_probe.chunked_taps_checksum(x, w, return_y=True),
    "i2": lambda p, w: conv_probe.tap_planes_checksum(p, w, return_y=True),
    "j2": lambda h, w: conv_probe.conv2_checksum(h, w, "slice", return_y=True, key="conv_chunked"),
    "j3": lambda h, w: conv_probe.conv2_checksum(h, w, "slice", return_y=True, key="conv_trailing"),
    "j4": lambda h, w: conv_probe.conv2_dx_window_checksum(h, w, return_y=True),
    "j5": lambda h, w: conv_probe.conv3_checksum(h, w, return_y=True),
    "c2": lambda xf, w: conv_probe.flat_chunks_checksum(xf, w, return_y=True),
}
# small geometries: module constants, then the shapes of x, p9, h1, h2arr, xf
CHUNK_GEOMS = {
    # F = 17: h2's second window clamps to 17 - 10 = 7; every staged row is scalar (F % 8 = 1)
    "odd": ({"CONV1_ROWS": 9, "H2_WINDOW": 8, "CONV2_ROWS": 9, "CONV2_SLICE_COLS": 13, "CONV3_ROWS": 9,
             "CONV3_COLS": 13, "FLAT_WIDTH": 7, "CHUNK_LEN": 100, "CHUNKS": 3},
            {"x": (3, 13, 17), "p9": (3, 9, 13, 17), "h1": (3, 13, 17, 32), "h2arr": (3, 13, 17, 64),
             "xf": (3, 2, 290)}),   # L - Mc = 190: chunk 2's nine taps all start at 190
    # F = 16: 16-byte staging, h2's window clamps to 6; c2's chunk 2 clamps taps 6-8 only (214-216 -> 210)
    "even": ({"CONV1_ROWS": 12, "H2_WINDOW": 8, "CONV2_ROWS": 10, "CONV2_SLICE_COLS": 14, "CONV3_ROWS": 10,
              "CONV3_COLS": 14, "FLAT_WIDTH": 7, "CHUNK_LEN": 100, "CHUNKS": 3},
             {"x": (2, 16, 16), "p9": (2, 9, 16, 16), "h1": (2, 12, 16, 32), "h2arr": (2, 12, 16, 64),
              "xf": (2, 1, 310)}),
    # B = 133: more conv2/conv3 tiles than the persistent grid takes at once; odd rows, column tails
    "many": ({"CONV1_ROWS": 9, "H2_WINDOW": 8, "CONV2_ROWS": 9, "CONV2_SLICE_COLS": 37, "CONV3_ROWS": 11,
              "CONV3_COLS": 41, "FLAT_WIDTH": 7, "CHUNK_LEN": 100, "CHUNKS": 3},
             {"x": (133, 13, 17), "p9": (133, 9, 13, 17), "h1": (133, 11, 40, 32), "h2arr": (133, 13, 44, 64),
              "xf": (133, 2, 290)}),
    # c2's chunks longer than one 2,048-output block, the last wholly clamped
    "long": ({"FLAT_WIDTH": 182, "CHUNK_LEN": 3000, "CHUNKS": 2},
             {"x": (1, 322, 130), "p9": (1, 9, 320, 24), "h1": (1, 162, 178, 32), "h2arr": (1, 82, 178, 64),
              "xf": (2, 3, 5500)}),
}
CHUNK_WEIGHTS = {"w9": (9, 32), "w2": (9, 32, 64), "w2i": (3, 96, 64), "w3": (9, 64, 128), "wt": (32, 16)}


def _chunk_inputs(geom, device, seed):
    """Stage 14/15 arrays at a small geometry (N(0,1), 0.1 N(0,1) weights, bf16)."""
    gen = torch.Generator().manual_seed(seed)
    shapes = {**CHUNK_GEOMS[geom][1], **CHUNK_WEIGHTS}
    return {k: (torch.randn(*s, generator=gen) * (0.1 if k in CHUNK_WEIGHTS else 1.0)).to(device, torch.bfloat16)
            for k, s in shapes.items()}


def _check_chunk_case(name, inp, w):
    """Every y against the plain version, the checksum within 1e-5 sum |y|,
    one launch under the stage's key, the sums alone equal to the sums with
    y, bit for bit."""
    case = CHUNK_CASES[name]
    key = "conv_chunked" if name in conv_probe.STAGE14_CASES else "conv_trailing"
    before = _build.launch_counts()
    out, y = CHUNK_Y[name](inp, w)
    want_y = case.plain(inp, w)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {**before, key: before[key] + 1}
    assert y.shape == want_y.shape and out.shape == (inp.shape[0], 8, 128)
    # exact bf16 products; f32 sums of 9 (conv1), 288 (conv2) or 576 (conv3) terms in another order
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-5)
    assert torch.equal(out, out[:, :1, :1].expand_as(out))
    dims = tuple(range(1, want_y.dim()))
    bound = 1e-5 * want_y.double().abs().sum(dim=dims)
    assert bool(((out[:, 0, 0].double() - want_y.double().sum(dim=dims)).abs() <= bound).all())
    assert torch.equal(case.kernel(inp, w), out)


@pytest.mark.parametrize("name", list(CHUNK_CASES))
@pytest.mark.parametrize("geom", list(CHUNK_GEOMS))
def test_conv_chunk_kernel_matches_plain(cuda, name, geom, monkeypatch):
    for const, value in CHUNK_GEOMS[geom][0].items():
        monkeypatch.setattr(conv_probe, const, value)
    arrs = _chunk_inputs(geom, cuda, seed=len(geom))
    case = CHUNK_CASES[name]
    _check_chunk_case(name, arrs[case.inp], arrs[case.weights])


@pytest.mark.parametrize("name", list(CHUNK_CASES))
def test_conv_chunk_kernel_at_stage_widths(cuda, name):
    """The stages' own arrays and windows at B=2 (h2's window from 126, c2's
    chunk 7 from 50,816)."""
    from dfac_tpu_torch.scripts.train_opt_probe import stage14_inputs, stage15_inputs

    inputs = stage14_inputs if name in conv_probe.STAGE14_CASES else stage15_inputs
    arrs = inputs(2, torch.bfloat16, cuda, seed=2)
    case = CHUNK_CASES[name]
    _check_chunk_case(name, arrs[case.inp], arrs[case.weights])


def test_conv_chunk_kernel_rejects_what_it_does_not_take(cuda, monkeypatch):
    for const, value in CHUNK_GEOMS["odd"][0].items():
        monkeypatch.setattr(conv_probe, const, value)
    arrs = _chunk_inputs("odd", cuda, seed=0)
    with pytest.raises(ValueError, match="32 output channels"):
        conv_probe.chunked_taps_checksum(arrs["x"], arrs["w9"][:, :16])
    with pytest.raises(TypeError, match="bfloat16"):
        conv_probe.tap_planes_checksum(arrs["p9"].float(), arrs["w9"].float())
    with pytest.raises(RuntimeError, match="CUDA error"):  # the C entry refuses 2,000 output channels
        conv_probe.tap_planes_checksum(arrs["p9"], torch.zeros(9, 2000, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="32 -> 64"):
        conv_probe.conv2_dx_window_checksum(arrs["h1"], arrs["w2i"][..., :32])
    with pytest.raises(ValueError, match="64 -> 128"):
        conv_probe.conv3_checksum(arrs["h2arr"], arrs["w3"][..., :64])
    with pytest.raises(ValueError, match="32 output channels"):
        conv_probe.flat_chunks_checksum(arrs["xf"], arrs["wt"][:16])
    with pytest.raises(ValueError, match="does not fit"):
        conv_probe.flat_chunks_checksum(arrs["xf"][..., :99], arrs["wt"])
    # j5 on 341 rows x 176 columns: 171 x 6 tiles, more than a sample's 1,024 result slots
    monkeypatch.setattr(conv_probe, "CONV3_ROWS", 341)
    monkeypatch.setattr(conv_probe, "CONV3_COLS", 176)
    with pytest.raises(RuntimeError, match="CUDA error"):
        conv_probe.conv3_checksum(torch.zeros(1, 343, 178, 64, device=cuda, dtype=torch.bfloat16), arrs["w3"])


CONV2_FAMILY = {  # the cases conv2_checksum serves: f(input, weights) -> (B, 8, 128), and their stage's arrays
    "j": (conv_probe.CASES["j"], "13"), "k": (conv_probe.CASES["k"], "13"),
    "f": (conv_probe.STAGE12_CASES["f"], "12"), "j2": (conv_probe.STAGE14_CASES["j2"], "14"),
    "j3": (conv_probe.STAGE15_CASES["j3"], "15"), "j4": (conv_probe.STAGE15_CASES["j4"], "15"),
    "j5": (conv_probe.STAGE15_CASES["j5"], "15"),
}


@pytest.mark.parametrize("name", list(CONV2_FAMILY))
def test_conv2_checksum_repeats_and_does_not_depend_on_the_batch(cuda, name):
    """At the stages' widths: a second call equals the first bit for bit,
    and each sample's sums from a batched call equal, bit for bit, a call on
    that sample alone and a call on the batch in reverse order (other tiles
    share its blocks, other blocks take its tiles)."""
    from dfac_tpu_torch.scripts import train_opt_probe

    case, stage = CONV2_FAMILY[name]
    arrs = getattr(train_opt_probe, f"stage{stage}_inputs")(5, torch.bfloat16, cuda, seed=5)
    inp, w = arrs[case.inp], arrs[case.weights]
    out = case.kernel(inp, w)
    assert torch.equal(case.kernel(inp, w), out)
    assert torch.equal(case.kernel(inp.flip(0), w), out.flip(0))
    for i in range(inp.shape[0]):
        assert torch.equal(case.kernel(inp[i : i + 1], w), out[i : i + 1])


CONV1_TC_FAMILY = {  # the cases conv1_tc serves: f(input, weights) -> (results, 8, 128), and their stage's arrays
    "g": (conv_probe.CASES["g"], "13"), "h": (conv_probe.CASES["h"], "13"), "i": (conv_probe.CASES["i"], "13"),
    "v2": (conv_probe.STAGE11_CASES["v2"], "11"), "v3": (conv_probe.STAGE11_CASES["v3"], "11"),
    "a": (conv_probe.STAGE12_CASES["a"], "12"), "c": (conv_probe.STAGE12_CASES["c"], "12"),
    "h2": (conv_probe.STAGE14_CASES["h2"], "14"), "i2": (conv_probe.STAGE14_CASES["i2"], "14"),
    "c2": (conv_probe.STAGE15_CASES["c2"], "15"),
}
# B = 5 for each case; B = 133 for g and i2 (more bands than the persistent grid takes at once, and 1,280
# 64-output tiles a sample, more than its 1,024 result slots); v3 at 17 samples: two groups of 8 and a tail
CONV1_TC_PARAMS = ([(name, 17 if name == "v3" else 5) for name in CONV1_TC_FAMILY]
                   + [("g", 133), ("i2", 133)])


@pytest.mark.parametrize("name,batch", CONV1_TC_PARAMS)
def test_conv1_tc_repeats_and_does_not_depend_on_the_batch(cuda, name, batch):
    """At the stages' widths: a second call equals the first bit for bit,
    and each result's sums from a batched call equal, bit for bit, a call on
    that result's samples alone and a call on the batch in reverse order
    (v3: its groups of 8 reversed, the tail left out)."""
    from dfac_tpu_torch.scripts import train_opt_probe

    case, stage = CONV1_TC_FAMILY[name]
    arrs = getattr(train_opt_probe, f"stage{stage}_inputs")(batch, torch.bfloat16, cuda, seed=batch)
    inp, w = arrs[case.inp], arrs[case.weights]
    group = conv_probe.GROUP if name == "v3" else 1
    n = inp.shape[0] // group
    units = inp[: n * group].reshape(n, group, *inp.shape[1:])  # a result's samples
    out = case.kernel(inp, w)
    assert out.shape == (n, 8, 128) and bool(torch.isfinite(out).all())
    assert torch.equal(case.kernel(inp, w), out)
    assert torch.equal(case.kernel(units.flip(0).reshape(-1, *inp.shape[1:]), w), out.flip(0))
    for i in range(n):
        assert torch.equal(case.kernel(units[i], w), out[i : i + 1])


CONV1_FMA_FAMILY = {"v1": (conv_probe.STAGE11_CASES["v1"], "11"), "d": (conv_probe.STAGE12_CASES["d"], "12")}


@pytest.mark.parametrize("batch", [5, 133])
@pytest.mark.parametrize("name", list(CONV1_FMA_FAMILY))
def test_conv1_checksum_repeats_and_does_not_depend_on_the_batch(cuda, name, batch):
    """The CUDA-core conv1 (v1, d) at the stages' widths, whose 321 and 319
    output rows are not a multiple of its 32-row band: a second call equals
    the first bit for bit, and each sample's sums from a batched call equal,
    bit for bit, a call on that sample alone and a call on the batch in
    reverse order. B = 133: more bands than the persistent grid takes at once."""
    from dfac_tpu_torch.scripts import train_opt_probe

    case, stage = CONV1_FMA_FAMILY[name]
    arrs = getattr(train_opt_probe, f"stage{stage}_inputs")(batch, torch.bfloat16, cuda, seed=batch)
    inp, w = arrs[case.inp], arrs[case.weights]
    out = case.kernel(inp, w)
    assert out.shape == (batch, 8, 128) and bool(torch.isfinite(out).all())
    assert torch.equal(case.kernel(inp, w), out)
    assert torch.equal(case.kernel(inp.flip(0), w), out.flip(0))
    for i in range(batch):
        assert torch.equal(case.kernel(inp[i : i + 1], w), out[i : i + 1])


# -- the w8a8 int8 conv block -------------------------------------------------------------------------------------

W8A8_CASES = [  # (B, H, W, C_in, C_out)
    (1, 2, 1, 32, 64), (1, 3, 7, 32, 64), (2, 9, 65, 32, 64), (3, 16, 64, 32, 64), (1, 33, 180, 32, 64),
    (2, 5, 63, 64, 128), (1, 4, 129, 64, 128), (2, 17, 180, 64, 128), (3, 8, 20, 64, 128), (2, 7, 70, 64, 128),
    (64, 20, 180, 32, 64), (40, 20, 180, 64, 128),  # many tiles a block: the halo ring wraps
]


def _w8a8_inputs(dev, b, h, w, cin, cout, seed=0, lo=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randint(lo, 128, (b, h, w, cin), generator=g, dtype=torch.int8)
    wq = torch.randint(-128, 128, (3, 3, cin, cout), generator=g, dtype=torch.int8)
    deq = torch.rand(cout, generator=g) * 2e-4 + 1e-5
    bias = torch.rand(cout, generator=g) - 0.5
    return (t.to(dev) for t in (x, wq, deq, bias))


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("b,h,w,cin,cout", W8A8_CASES)
def test_conv_block_w8a8_matches_plain_bit_for_bit(cuda, b, h, w, cin, cout, quantized):
    x, wq, deq, bias = _w8a8_inputs(cuda, b, h, w, cin, cout)
    inv_s = 1.0 / 0.05 if quantized else None
    before = _build.launch_counts()["conv_block_w8a8"]
    got = conv_block_w8a8(x, wq, deq, bias, inv_s)
    torch.cuda.synchronize()
    assert _build.launch_counts()["conv_block_w8a8"] == before + (1 if got.numel() else 0)
    want = reference_conv_block_w8a8(x, wq, deq, bias, inv_s)
    assert got.dtype == want.dtype == (torch.int8 if quantized else torch.float32)
    assert got.shape == want.shape == (b, h // 2 if quantized else h, w, cout)
    assert torch.equal(got, want)
    assert torch.equal(conv_block_w8a8(x, wq, deq, bias, inv_s), got)  # a second call, bit for bit


@pytest.mark.parametrize("cin,cout", [(32, 64), (64, 128)])
def test_conv_block_w8a8_saturates(cuda, cin, cout):
    """Every code 127 or -128 and the largest weights: |acc| at its bound;
    the quantized mode clips at 127 and the pool stays in range."""
    x = torch.full((2, 6, 70, cin), 127, dtype=torch.int8, device=cuda)
    x[1] = -128
    wq = torch.full((3, 3, cin, cout), -128, dtype=torch.int8, device=cuda)
    wq[..., ::2] = 127
    deq = torch.full((cout,), 1e-3, device=cuda)
    bias = torch.zeros(cout, device=cuda)
    for inv_s in (1.0, None):
        got = conv_block_w8a8(x, wq, deq, bias, inv_s)
        assert torch.equal(got, reference_conv_block_w8a8(x, wq, deq, bias, inv_s))
    assert int(conv_block_w8a8(x, wq, deq, bias, 1.0).max()) == 127


def test_conv_block_w8a8_misaligned_input(cuda):
    x, wq, deq, bias = _w8a8_inputs(cuda, 2, 6, 33, 32, 64, seed=1)
    base = torch.zeros(x.numel() + 8, dtype=torch.int8, device=cuda)
    xm = base[8:].view(x.shape)  # 8 bytes past a 16-byte boundary
    xm.copy_(x)
    assert xm.data_ptr() % 16 == 8
    assert torch.equal(conv_block_w8a8(xm, wq, deq, bias, 20.0), reference_conv_block_w8a8(x, wq, deq, bias, 20.0))


def test_conv_block_w8a8_refuses_what_it_does_not_take(cuda):
    x, wq, deq, bias = _w8a8_inputs(cuda, 1, 4, 8, 32, 64)
    with pytest.raises(TypeError):
        conv_block_w8a8(x.float(), wq, deq, bias)
    with pytest.raises(ValueError):
        conv_block_w8a8(x[..., :16].contiguous(), wq[:, :, :16].contiguous(), deq, bias)  # C_in 16
    with pytest.raises(ValueError):
        conv_block_w8a8(x, wq, deq[:32], bias)
    assert _build.library().dfac_conv_block_w8a8_smem(32, 64) > 48 * 1024


def test_conv_block_w8a8_mean_mode_matches_plain(cuda):
    """The mean mode (block 3 and the head's mean over time) bit for bit
    with its plain version, whose sum takes the kernel's order; the counts;
    a second call equal (no float atomics)."""
    for b, h, w, cin, cout in W8A8_CASES:
        x, wq, deq, bias = _w8a8_inputs(cuda, b, h, w, cin, cout)
        before = _build.launch_counts()["conv_block_w8a8"]
        got = conv_block_w8a8(x, wq, deq, bias, time_mean=True)
        torch.cuda.synchronize()
        assert _build.launch_counts()["conv_block_w8a8"] == before + 1
        want = reference_conv_block_w8a8(x, wq, deq, bias, time_mean=True)
        assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape == (b, w, cout)
        assert torch.equal(got, want), (b, h, w, cin, cout)
        assert torch.equal(conv_block_w8a8(x, wq, deq, bias, time_mean=True), got)


def test_conv_block_w8a8_mean_mode_saturates_and_refuses(cuda):
    x = torch.full((2, 5, 70, 64), 127, dtype=torch.int8, device=cuda)
    x[1] = -128
    wq = torch.full((3, 3, 64, 128), -128, dtype=torch.int8, device=cuda)
    wq[..., ::2] = 127
    deq, bias = torch.full((128,), 1e-3, device=cuda), torch.zeros(128, device=cuda)
    got = conv_block_w8a8(x, wq, deq, bias, time_mean=True)
    assert torch.equal(got, reference_conv_block_w8a8(x, wq, deq, bias, time_mean=True)) and float(got.max()) > 0
    with pytest.raises(ValueError):
        conv_block_w8a8(x, wq, deq, bias, 1.0, time_mean=True)


W8A8_MAX_MOVED = 1e-3  # bf16 block 1: tensor-core sums may move a code by one step (tests/test_torch_port_int8.py)
B1_CASES = [  # (B, T, F)
    (128, 321, 180),  # the serving shape
    (1, 2, 1), (1, 3, 7), (2, 9, 65), (3, 16, 33), (2, 33, 180),
]


def _block1_inputs(b, t, f, seed=0):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(b, f, t + 1, generator=g)[..., 1:]  # stored (B, F, T), a storage offset
    w1 = torch.randn(3, 3, 1, 32, generator=g) * 0.3
    b1 = torch.randn(32, generator=g) * 0.1
    return feats, w1, b1


def _codes_agree(got, want, exact):
    if exact:
        return torch.equal(got, want)
    d = (got.int() - want.int()).abs()
    return int(d.max()) <= 1 and float((d > 0).float().mean()) <= W8A8_MAX_MOVED


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block1_w8a8_kernel_matches_plain(cuda, dtype):
    """f32: bit for bit (the plain version takes the kernel's order); bf16:
    within one step at <= 0.1% of positions. On the chain's transposed view
    of a stored batch and on a contiguous (B, T, F) one; the counts; a
    second call equal."""
    for b, t, f in B1_CASES:
        feats, w1, b1 = (a.to(cuda) for a in _block1_inputs(b, t, f))
        for x in (feats.to(dtype).transpose(1, 2), feats.transpose(1, 2).contiguous().to(dtype)):
            before = _build.launch_counts()["block1_w8a8"]
            got = block1_w8a8(x, w1, b1, 127 / 3.0, dtype)
            torch.cuda.synchronize()
            assert _build.launch_counts()["block1_w8a8"] == before + 1
            want = reference_block1_w8a8(x, w1, b1, 127 / 3.0, dtype)
            assert got.dtype == torch.int8 and got.shape == want.shape == (b, t // 2, f, 32)
            assert _codes_agree(got, want, dtype == torch.float32), (b, t, f)
            assert torch.equal(block1_w8a8(x, w1, b1, 127 / 3.0, dtype), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block1_w8a8_saturates(cuda, dtype):
    """Large scales clip at 127, negative sums give 0, and the pool of two
    127s stays 127."""
    feats, w1, b1 = (a.to(cuda) for a in _block1_inputs(2, 11, 40, seed=3))
    x = feats.transpose(1, 2).to(dtype)
    for inv_s in (1e6, 1.0):
        got = block1_w8a8(x, w1, b1, inv_s, dtype)
        assert _codes_agree(got, reference_block1_w8a8(x, w1, b1, inv_s, dtype), dtype == torch.float32)
    got = block1_w8a8(x.abs(), w1.abs(), b1.abs() + 1, 1e6, dtype)
    assert int(got.min()) == 127 and int(got.max()) == 127
    assert int(block1_w8a8(x.abs(), -w1.abs(), -b1.abs() - 1, 1e6, dtype).max()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_chain_cuda_three_launches(cuda, dtype):
    """The w8a8 chain on stored (B, F, T) features: 1 block-1 and 2
    conv_block_w8a8 launches and no other kernel of the port; scores
    against the same chain's plain versions on the CPU."""
    from dfac_tpu_torch.chain_rates import seed_batchnorm
    from dfac_tpu_torch.models import build_model
    from dfac_tpu_torch.models import fast_infer_int8 as w8

    torch.manual_seed(0)
    model = seed_batchnorm(build_model("cnn2d", in_features=20).eval(), torch.Generator().manual_seed(1))
    feats = torch.randn(6, 20, 33, generator=torch.Generator().manual_seed(2))
    f8 = w8.fold_cnn2d_w8a8(model.state_dict(), feats.numpy())
    want = w8.cnn2d_w8a8_scores(f8, feats, compute_dtype=dtype)
    f8_dev = {k: v.to(cuda) if k not in ("inv_s1", "inv_s2") else v for k, v in f8.items()}
    _build.reset_launch_counts()
    got = w8.cnn2d_w8a8_scores(f8_dev, feats.to(cuda), compute_dtype=dtype)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    assert counts == {**dict.fromkeys(counts, 0), "block1_w8a8": 1, "conv_block_w8a8": 2}
    torch.testing.assert_close(got.cpu(), want, atol=1e-3 if dtype == torch.float32 else 2e-2, rtol=0)
