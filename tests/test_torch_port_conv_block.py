"""PyTorch port of the fused conv block against the JAX package's Pallas kernels.

On a CPU tensor ``dfac_tpu_torch.ops.conv_block.fused_conv_block`` runs the
plain version of its CUDA kernel; here it is held to ``fused_conv_block_v2``
and ``fused_conv_block`` (Pallas, interpret mode) and to
``reference_conv_block`` (XLA), on inputs made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from dfac_tpu.ops.pallas import conv_block as jcb
from dfac_tpu_torch.ops import conv_block as tcb
from dfac_tpu_torch.ops import conv_probe as tcp

CASES = [
    (64, 24, 8, 16, True),
    (33, 24, 8, 16, True),   # odd H: floor-mode pool drops the tail row
    (32, 24, 8, 16, False),
    (40, 20, 1, 8, True),    # single input channel (block 1)
    (96, 24, 8, 16, True),   # several Pallas tiles
    (6, 20, 32, 64, True),   # block 2's channel counts (the f32 kernel's 32 -> 64)
    (5, 20, 64, 128, False), # block 3's (64 -> 128), odd H unpooled
]


def _inputs(h, w, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, w, cin)).astype(np.float32)
    wk = (rng.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, wk, b


@pytest.mark.parametrize("h,w,cin,cout,pool", CASES)
def test_conv_block_matches_pallas_v2_and_xla(h, w, cin, cout, pool):
    x, wk, b = _inputs(h, w, cin, cout)
    got = tcb.fused_conv_block(torch.from_numpy(x), torch.from_numpy(wk), torch.from_numpy(b), pool).numpy()
    with pltpu.force_tpu_interpret_mode():
        v2 = np.asarray(jcb.fused_conv_block_v2(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(b), pool=pool))
    ref = np.asarray(jcb.reference_conv_block(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(b), pool=pool))
    assert got.shape == v2.shape == ref.shape
    # f32 throughout; only the summation order of the 9 * C_in terms differs
    # (the bound tests/test_conv_block.py holds the Pallas kernels to)
    np.testing.assert_allclose(got, v2, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def _cin1_tc_product(x, wk, scale):
    """Both conv rows of every pooled pixel as the tensor-core kernels' one
    product, in f32: A (pooled pixels x 16) by ``CIN1_TC_K``, B (16 x 64) by
    ``CIN1_TC_K`` and ``CIN1_TC_N``, scaled by ``scale`` -> (B, H // 2, W, 64)."""
    batch, h, width, _ = x.shape
    h_out = h // 2
    xp = F.pad(x[..., 0], (1, 1, 1, 1))  # window row i of pooled row ho is padded row 2ho + i
    a = torch.zeros(batch, h_out, width, 16)
    bm = torch.zeros(16, 64)
    for k, rc in enumerate(tcb.CIN1_TC_K):
        if rc is None:
            continue
        row, col = rc
        a[..., k] = xp[:, row : row + 2 * h_out : 2, col : col + width]
        for n, (conv_row, ch) in enumerate(tcb.CIN1_TC_N):
            if 0 <= row - conv_row < 3:  # conv row r's tap dy reads window row dy + r
                bm[k, n] = scale * wk[row - conv_row, col, 0, ch]
    return a @ bm


def _cin1_tc_block(x, wk, b):
    """Block 1 (C_in = 1, C_out = 32, pooled) through the tensor-core
    kernel's product, B and the bias scaled by ``CIN1_TC_SCALE``, then per
    channel relu(conv row 0) + relu(conv row 1)."""
    bias = tcb.CIN1_TC_SCALE * b[[ch for _, ch in tcb.CIN1_TC_N]]
    y = torch.relu(_cin1_tc_product(x, wk, tcb.CIN1_TC_SCALE) + bias)
    out = torch.zeros(*y.shape[:-1], 32)
    for n, (_, ch) in enumerate(tcb.CIN1_TC_N):  # the pool: each channel's column of both conv rows
        out[..., ch] += y[..., n]
    return out


@pytest.mark.parametrize("h,w", [(2, 5), (3, 1), (8, 24), (33, 65), (40, 180)])  # even and odd H; W 1 to 180
def test_cin1_tensor_core_map_matches_pallas_v2_and_plain(h, w):
    x, wk, b = _inputs(h, w, 1, 32, seed=h + w)
    got = _cin1_tc_block(torch.from_numpy(x), torch.from_numpy(wk), torch.from_numpy(b)).numpy()
    with pltpu.force_tpu_interpret_mode():
        v2 = np.asarray(jcb.fused_conv_block_v2(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(b), pool=True))
    plain = tcb.reference_conv_block(torch.from_numpy(x), torch.from_numpy(wk), torch.from_numpy(b), True).numpy()
    assert got.shape == v2.shape == plain.shape == (2, h // 2, w, 32)
    # f32 throughout; the products are exact, the summation order differs
    np.testing.assert_allclose(got, v2, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, plain, atol=1e-4, rtol=1e-4)


def _emit_halved(y0, y1):
    """v4's epilogue as its CUDA kernel runs it on conv rows 2t and 2t + 1
    whose y arrive halved (B scaled by ``CIN1_TC_SCALE``): relu(y 1.01 +
    0.01 / 2) of each, summed (in f32; one cast to bf16 follows)."""
    scale, shift = tcp.EMIT_AFFINE
    half = tcb.CIN1_TC_SCALE
    return torch.relu(y0 * scale + half * shift) + torch.relu(y1 * scale + half * shift)


def _cin1_tc_emit(x, w):
    """Stage 11's v4 (``conv1_emit``) through the same product, as its CUDA
    kernel forms it: B halved and C zero, then :func:`_emit_halved` of each
    channel's two conv rows."""
    y = _cin1_tc_product(x[..., None], w[:, :, None, :], tcb.CIN1_TC_SCALE)
    rows = torch.zeros(2, *y.shape[:-1], 32)
    for n, (conv_row, ch) in enumerate(tcb.CIN1_TC_N):
        rows[conv_row][..., ch] = y[..., n]
    return _emit_halved(rows[0], rows[1]).to(torch.bfloat16)


@pytest.mark.parametrize("t,f", [(8, 24), (33, 21), (7, 13)])  # odd T (the last conv row dropped), F % 8 != 0
def test_emit_tensor_core_map_matches_plain(t, f):
    """v4's tensor-core kernel computes the emit through K2 block 1's maps:
    within one bf16 last bit of ``conv1_emit_plain`` (f32 sums of the exact
    products in another order can straddle a rounding boundary)."""
    rng = np.random.default_rng(t + f)
    x = torch.from_numpy(rng.normal(size=(2, t, f)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((0.2 * rng.normal(size=(3, 3, 32))).astype(np.float32)).to(torch.bfloat16)
    got = _cin1_tc_emit(x.float(), w.float()).float()
    want = tcp.conv1_emit_plain(x, w).float()
    assert got.shape == want.shape == (2, t // 2, f, 32)
    assert bool(((got - want).abs() <= 2.0**-7 * torch.maximum(got.abs(), want.abs()) + 1e-4).all())


def test_emit_on_halved_y_is_the_plain_epilogue_bit_for_bit():
    """Halving commutes with each rounding of the epilogue, so the kernel's
    epilogue on y / 2 equals the plain version's 0.5 (relu(y 1.01 + 0.01) +
    relu(y' 1.01 + 0.01)) on y, bit for bit (normal y; zeros and values
    around the ReLU's edge included)."""
    rng = np.random.default_rng(7)
    y = torch.from_numpy(np.concatenate([rng.normal(size=(2, 4096)) * 10.0 ** rng.integers(-6, 4, size=(2, 4096)),
                                         np.array([[0.0, -0.0099, -0.00990099, 1e-30], [0.0, 0.0, -1.0, 3.0]])],
                                        axis=1).astype(np.float32))
    scale, shift = tcp.EMIT_AFFINE
    plain = (0.5 * (torch.clamp_min(y[0] * scale + shift, 0.0) + torch.clamp_min(y[1] * scale + shift, 0.0)))
    assert torch.equal(_emit_halved(0.5 * y[0], 0.5 * y[1]), plain)


def test_conv_block_matches_pallas_v1():
    x, wk, b = _inputs(33, 24, 8, 16, seed=1)
    got = tcb.reference_conv_block(torch.from_numpy(x), torch.from_numpy(wk), torch.from_numpy(b), True).numpy()
    with pltpu.force_tpu_interpret_mode():
        v1 = np.asarray(jcb.fused_conv_block(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(b), pool=True))
    np.testing.assert_allclose(got, v1, atol=1e-4, rtol=1e-4)


def test_conv_block_bf16_pools_before_the_cast():
    """bf16: the pool runs in f32 and the result is cast once, as in the
    Pallas epilogue; the two sides differ only where an f32 sum taken in
    another order rounds to the neighbouring bf16 value (one last bit)."""
    x, wk, b = _inputs(33, 24, 8, 16, seed=2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tcb.fused_conv_block(xb, torch.from_numpy(wk), torch.from_numpy(b), True)
    assert got.dtype == torch.bfloat16
    with pltpu.force_tpu_interpret_mode():
        want = jcb.fused_conv_block_v2(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wk), jnp.asarray(b), pool=True)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    bound = 2.0**-7 * np.maximum(np.abs(got), np.abs(want)) + 1e-6
    assert (np.abs(got - want) <= bound).all()


def test_conv_block_rejects_other_devices():
    x, wk, b = _inputs(8, 8, 2, 4)
    with pytest.raises(ValueError):
        tcb.fused_conv_block(torch.from_numpy(x).to("meta"), torch.from_numpy(wk), torch.from_numpy(b))


def _f32_block_through_tiles(x, wk, b, pool):
    """Blocks 2 and 3 in f32 through the f32 kernel's tiling
    (``f32_tile_geometry``): each tile's halo is cut from the zero-padded
    input, each thread's 2 x 9 x 4 register tile reads its taps from that
    halo, and its epilogue writes its outputs. Returns the output and how
    many times each output value was written."""
    batch, h, width, cin = x.shape
    c_out = wk.shape[-1]
    g = tcb.f32_tile_geometry(h, width, c_out, pool)
    rp_n, halo_rows, tw = g["row_pairs"], g["halo_rows"], tcb.F32_TW
    h_out = h // 2 if pool else h
    # padded so that every halo window of every tile is a slice: conv row -1 and column -1 first
    rows_pad = g["row_tiles"] * 2 * rp_n + 2
    xp = torch.zeros(batch, rows_pad, g["col_tiles"] * tw + 2, cin)
    xp[:, 1 : h + 1, 1 : width + 1] = x
    out = torch.zeros(batch, h_out, width, c_out)
    writes = torch.zeros(batch, h_out, width, c_out, dtype=torch.int64)
    r_idx = 2 * g["rp"][:, None, None] + torch.arange(2)[None, :, None]  # (thread, r, 1): tile conv row
    c_idx = tcb.F32_COLS * g["colg"][:, None] + torch.arange(tcb.F32_COLS)[None, :]  # (thread, c): tile column
    ch = tcb.F32_CH * g["chg"][:, None] + torch.arange(tcb.F32_CH)[None, :]  # (thread, e)
    for bi in range(batch):
        for rt in range(g["row_tiles"]):
            for ct in range(g["col_tiles"]):
                halo = xp[bi, 2 * rp_n * rt : 2 * rp_n * rt + halo_rows, ct * tw : ct * tw + tw + 2]
                acc = torch.zeros(tcb.F32_THREADS, 2, tcb.F32_COLS, tcb.F32_CH)
                for dy in range(3):
                    for dx in range(3):
                        hr, hc = r_idx + dy, c_idx[:, None, :] + dx
                        assert int(hr.max()) < halo_rows and int(hc.max()) < tw + 2 and int(hc.min()) >= 0
                        taps = halo[hr.expand(-1, -1, tcb.F32_COLS), hc.expand(-1, 2, -1)]  # (thread, r, c, cin)
                        acc += torch.einsum("trci,tie->trce", taps, wk[dy, dx][:, ch].permute(1, 0, 2))
                y = torch.relu(acc + b[ch][:, None, None, :])
                pair = rt * rp_n + g["rp"]
                cols = ct * tw + c_idx
                for t in range(tcb.F32_THREADS):
                    for r in range(2):
                        orow = int(pair[t]) if pool else 2 * int(pair[t]) + r
                        if (pool and (r or orow >= h_out)) or (not pool and orow >= h):
                            continue
                        keep = cols[t] < width
                        val = (y[t, 0] + y[t, 1]) * 0.5 if pool else y[t, r]
                        out[bi, orow, cols[t][keep][:, None], ch[t][None, :]] = val[keep]
                        writes[bi, orow, cols[t][keep][:, None], ch[t][None, :]] += 1
    return out, writes


@pytest.mark.parametrize("width", [1, 60, 61, 180])  # one column, ragged and whole 36-column tiles, serving W
@pytest.mark.parametrize("h", [4, 5])
@pytest.mark.parametrize("cin,cout,pool", [(32, 64, True), (64, 128, False)])
def test_f32_tiles_write_each_output_once_and_read_inside_the_halo(width, h, cin, cout, pool):
    x, wk, b = _inputs(h, width, cin, cout, seed=width + h)
    xt, wt, bt = torch.from_numpy(x[:1]), torch.from_numpy(wk), torch.from_numpy(b)
    got, writes = _f32_block_through_tiles(xt, wt, bt, pool)
    assert (writes == 1).all()
    plain = tcb.reference_conv_block(xt, wt, bt, pool)
    # f32 throughout; the summation order differs
    torch.testing.assert_close(got, plain, atol=1e-4, rtol=1e-4)
