"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips without a card. This file imports only
torch and the port, so it runs where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q``.

Tolerances: the PCA kernel sums the same bf16 products in f32 in another
order than cuBLAS, atol/rtol 1e-5; the warp kernel repeats the plain
version's f32 operations in the same order, atol 1e-6."""
import pytest
import torch

from liftreg_tpu_torch.ops.pca_kernel import pca_expand, pca_expand_plain
from liftreg_tpu_torch.ops.warp_kernel import (warp_trilinear,
                                               warp_trilinear_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,L,n", [(4, 56, 3 * 40 ** 3), (3, 7, 3 * 49 ** 3),
                                   (8, 5, 1001), (1, 3, 7)])
def test_pca_kernel_matches_plain(device, B, L, n):
    g = torch.Generator(device=device).manual_seed(0)
    coefs = torch.randn((B, L), generator=g, device=device)
    V = (torch.randn((L, n), generator=g, device=device) * 0.01).bfloat16()
    mean = torch.randn((n,), generator=g, device=device) * 0.01
    before = pca_expand.launches
    got = pca_expand(coefs, V, mean)
    torch.cuda.synchronize()
    assert pca_expand.launches == before + 1
    torch.testing.assert_close(got, pca_expand_plain(coefs, V, mean),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("taps", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("border", [False, True])
def test_warp_kernel_matches_plain(device, taps, border):
    g = torch.Generator(device=device).manual_seed(1)
    B, C, D, W, H = 2, 2, 20, 24, 28
    vol = torch.rand((B, C, D, W, H), generator=g, device=device).to(taps)
    scale = torch.tensor([D, W, H], dtype=torch.float32, device=device)
    coords = torch.rand((B, 5000, 3), generator=g, device=device) \
        * (scale + 40.0) - 20.0
    before = warp_trilinear.launches
    got = warp_trilinear(vol, coords, border)
    torch.cuda.synchronize()
    assert warp_trilinear.launches == before + 1
    torch.testing.assert_close(got, warp_trilinear_plain(vol, coords, border),
                               atol=1e-6, rtol=0)


def test_wrappers_reject_bad_cuda_inputs(device):
    V = torch.zeros((3, 16), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError):
        pca_expand(torch.zeros((9, 3), device=device), V,
                   torch.zeros(16, device=device))
    with pytest.raises(TypeError):
        pca_expand(torch.zeros((2, 3), device=device), V.float(),
                   torch.zeros(16, device=device))
    with pytest.raises(ValueError):
        warp_trilinear(torch.zeros((1, 1, 4, 4, 4), device=device),
                       torch.zeros((1, 3, 6), device=device)[..., ::2],
                       False)
