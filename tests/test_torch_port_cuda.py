"""The port's CUDA kernels against their plain versions, at edge-case shapes.

Marked ``cuda``: every test needs an NVIDIA GPU with ``nvcc`` and skips
elsewhere (the kernels have no CPU mode). ``chip_smoke.py`` checks the
serving shapes; these check the edges (odd H with and without the pool, W
not a multiple of the 64-column tile, tiny H and T, every kernel case of
the conv block, f32, misaligned inputs). On the card, without the JAX
package's conftest (this file imports no JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q
"""

import pytest
import torch

from dfac_tpu_torch.features.lfcc import LFCCConfig
from dfac_tpu_torch.ops import _build
from dfac_tpu_torch.ops.conv_block import fused_conv_block, reference_conv_block
from dfac_tpu_torch.ops.gemm_frontend import cepstra_plain, gemm_lfcc_cepstra

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


@pytest.mark.parametrize("lead,frames", [((1,), 1), ((3,), 17), ((2, 3), 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_frontend_kernel_matches_plain(cuda, lead, frames, dtype):
    gen = torch.Generator().manual_seed(frames)
    wave = torch.randn(*lead, CFG.num_samples(frames) + 37, generator=gen).to(cuda)  # ragged tail
    before = _build.launch_counts()["gemm_frontend"]
    got = gemm_lfcc_cepstra(wave, CFG, dtype)
    want = cepstra_plain(wave, CFG, dtype)
    torch.cuda.synchronize()
    assert _build.launch_counts()["gemm_frontend"] == before + 1
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
]


@pytest.mark.parametrize("b,h,w,cin,cout,pool", CONV_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
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
    if dtype == torch.bfloat16:
        assert _close_bf16_last_bit(got, want)  # sums rounded to bf16 in other orders
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)  # f32 order only


def test_conv_block_misaligned_input(cuda):
    gen = torch.Generator().manual_seed(1)
    flat = torch.randn(1 + 2 * 6 * 70 * 32, generator=gen).to(cuda, torch.bfloat16)
    x = flat[1:].view(2, 6, 70, 32)  # data pointer 2 bytes past an aligned one
    wk = torch.randn(3, 3, 32, 64, generator=gen).to(cuda) * 0.1
    bias = torch.zeros(64, device=cuda)
    got = fused_conv_block(x, wk, bias, True)
    torch.testing.assert_close(got, fused_conv_block(x.clone(), wk, bias, True), atol=0, rtol=0)


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
