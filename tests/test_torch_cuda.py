"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips without a card. This file imports only
torch and the port, so it runs where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q``.

Tolerances: the PCA kernel sums the same bf16 products in f32 in another
order than cuBLAS, atol/rtol 1e-5; the warp kernel repeats the plain
version's f32 operations in the same order, atol 1e-6. The DRR projector
sums the planes in another order than the plain dense products: atol
1e-5 * max|plain|, rtol 1e-5; the lift adds at most 4 taps: atol 1e-6,
rtol 1e-5, and its bf16 output into a buffer equals its f32 output
rounded to bf16, bit for bit. The warp's coordinate gradient uses fused multiply-adds where
the plain version rounds twice: atol 1e-5 * max|plain|. The phi-layout
entries of both warp kernels hold the same tolerances: the forward makes
the pixel coordinates and the ``* 2 - 1`` rescale with the plain glue's
f32 roundings. The PCA backward
rounds an f32 sum taken in another order to bf16: one bf16 step, rtol
2^-8, plus atol 1e-4 * max|plain| for sums that cancel to near zero."""
import pytest
import torch

from liftreg_tpu_torch.ops import drr
from liftreg_tpu_torch.ops.drr_kernel import (backproject_taps,
                                              backproject_taps_plain,
                                              project_taps,
                                              project_taps_plain)
from liftreg_tpu_torch.ops.pca_kernel import (MAX_CHUNK, pca_expand,
                                              pca_expand_plain, pca_grad,
                                              pca_grad_plain)
from liftreg_tpu_torch.ops.warp_kernel import (warp_coord_grad,
                                               warp_coord_grad_plain,
                                               warp_trilinear,
                                               warp_trilinear_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,L,n", [(4, 56, 3 * 40 ** 3), (3, 7, 3 * 49 ** 3),
                                   (8, 5, 1001), (1, 3, 7),
                                   (9, 56, 3 * 24 ** 3), (30, 56, 3 * 24 ** 3),
                                   (30, 7, 1001)])
def test_pca_kernel_matches_plain(device, B, L, n):
    g = torch.Generator(device=device).manual_seed(0)
    coefs = torch.randn((B, L), generator=g, device=device)
    V = (torch.randn((L, n), generator=g, device=device) * 0.01).bfloat16()
    mean = torch.randn((n,), generator=g, device=device) * 0.01
    before = pca_expand.launches
    got = pca_expand(coefs, V, mean)
    torch.cuda.synchronize()
    # one launch per chunk of at most MAX_CHUNK batch rows
    assert pca_expand.launches == before + -(-B // MAX_CHUNK)
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


@pytest.mark.parametrize("shape", [(1, 6, 7), (5, 1, 7), (5, 6, 1),
                                   (1, 1, 4)])
@pytest.mark.parametrize("taps", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("border", [False, True])
def test_warp_kernels_unit_dim_match_plain(device, shape, taps, border):
    """A spatial dim of 1 takes the quad or generic axis modes in both
    kernels (forward atol 1e-6, gradient atol 1e-5 * max|plain|)."""
    g = torch.Generator(device=device).manual_seed(6)
    B, C, M = 2, 2, 4000
    vol = torch.rand((B, C) + shape, generator=g, device=device).to(taps)
    scale = torch.tensor(shape, dtype=torch.float32, device=device)
    coords = torch.rand((B, M, 3), generator=g, device=device) \
        * (scale + 2.0) - 1.5
    coords[:, ::4] = torch.floor(coords[:, ::4])
    cot = torch.randn((B, C, M), generator=g, device=device)
    before = (warp_trilinear.launches, warp_coord_grad.launches)
    got = warp_trilinear(vol, coords, border)
    got_grad = warp_coord_grad(vol, coords, cot, border)
    torch.cuda.synchronize()
    assert (warp_trilinear.launches, warp_coord_grad.launches) == \
        (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, warp_trilinear_plain(vol, coords, border),
                               atol=1e-6, rtol=0)
    want = warp_coord_grad_plain(vol, coords, cot, border)
    torch.testing.assert_close(got_grad, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_wrappers_reject_bad_cuda_inputs(device):
    V = torch.zeros((3, 16), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError):
        pca_expand(torch.zeros((9, 4), device=device), V,
                   torch.zeros(16, device=device))
    with pytest.raises(TypeError):
        pca_expand(torch.zeros((2, 3), device=device), V.float(),
                   torch.zeros(16, device=device))
    with pytest.raises(ValueError):
        warp_trilinear(torch.zeros((1, 1, 4, 4, 4), device=device),
                       torch.zeros((1, 3, 6), device=device)[..., ::2],
                       False)


def _edge_pix(g, shape, n, device):
    """Uniform coordinates with a third replaced by the edges of the
    per-tap zero padding: (-1, 0), 0, n-1, (n-1, n) and beyond."""
    pix = torch.rand(shape, generator=g, device=device) * (n + 3.0) - 2.0
    special = torch.tensor([-1.5, -1.0, -0.25, 0.0, 0.5, n - 1.0, n - 0.75,
                            n - 1.5, float(n), n + 2.0], device=device)
    pick = torch.randint(0, len(special), shape, generator=g, device=device)
    mask = torch.rand(shape, generator=g, device=device) < 0.33
    return torch.where(mask, special[pick], pix).contiguous()


# (B, (D, W, H), detector): the projector's and the lift's first cases
# (ragged); few planes (one plane chunk); five volumes (two batch groups);
# the serving shape. Each runs with 3 and 4 views.
DRR_SHAPES = [(2, (20, 17, 22), (30, 27)), (2, (16, 13, 19), (24, 25)),
              (3, (13, 9, 11), (21, 19)), (5, (24, 33, 20), (37, 29)),
              (4, (160, 160, 160), (240, 240))]


@pytest.mark.parametrize("B,vol_shape,res", DRR_SHAPES)
@pytest.mark.parametrize("views", [3, 4])
@pytest.mark.parametrize("geometry", ["poses", "edges"])
def test_drr_project_kernel_matches_plain(device, geometry, views, B,
                                          vol_shape, res):
    g = torch.Generator(device=device).manual_seed(2)
    D, W, H = vol_shape
    vol = torch.rand((B, D, W, H), generator=g, device=device)
    poses = torch.from_numpy(drr.synthesize_poses(30.0, views, W)).to(device)
    x_pix, z_pix, dx = drr.forward_geometry(poses, (D, W, H), res,
                                            (2.2, 2.0, 2.4))
    if geometry == "edges":
        x_pix = _edge_pix(g, tuple(x_pix.shape), D, device)
        z_pix = _edge_pix(g, tuple(z_pix.shape), H, device)
    before = project_taps.launches
    got = project_taps(vol, x_pix, z_pix, dx)
    torch.cuda.synchronize()
    assert project_taps.launches == before + 1
    want = project_taps_plain(vol, x_pix, z_pix, dx)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("B,vol_shape,det", DRR_SHAPES)
@pytest.mark.parametrize("views", [3, 4])
@pytest.mark.parametrize("geometry", ["poses", "edges"])
def test_drr_backproject_kernel_matches_plain(device, geometry, views, B,
                                              vol_shape, det):
    g = torch.Generator(device=device).manual_seed(3)
    proj = torch.rand((B, views) + det, generator=g, device=device) * 2.0 \
        - 1.0
    poses = torch.from_numpy(drr.synthesize_poses(30.0, views, vol_shape[1])
                             ).to(device)
    u_pix, v_pix = drr.backward_geometry(poses, vol_shape, det)
    if geometry == "edges":
        u_pix = _edge_pix(g, tuple(u_pix.shape), det[0], device)
        v_pix = _edge_pix(g, tuple(v_pix.shape), det[1], device)
    before = backproject_taps.launches
    got = backproject_taps(proj, u_pix, v_pix)
    torch.cuda.synchronize()
    assert backproject_taps.launches == before + 1
    torch.testing.assert_close(got, backproject_taps_plain(proj, u_pix, v_pix),
                               rtol=1e-5, atol=1e-6)
    # into a bf16 encoder buffer: the f32 values rounded once, bit for bit
    buf = torch.full((B, 1 + views) + tuple(vol_shape), 3.0,
                     dtype=torch.bfloat16, device=device)
    backproject_taps(proj, u_pix, v_pix, out=buf[:, 1:])
    torch.cuda.synchronize()
    assert backproject_taps.launches == before + 2
    assert torch.equal(buf[:, 1:], got.bfloat16())
    assert bool((buf[:, 0] == 3.0).all())


def _unaligned(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary (the kernels' scalar paths)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("taps", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("border", [False, True])
@pytest.mark.parametrize("kind", ["uniform", "integer"])
@pytest.mark.parametrize("layout", ["aligned", "ragged_m", "unaligned",
                                    "unit_w"])
def test_warp_coord_grad_kernel_matches_plain(device, taps, border, kind,
                                              layout):
    """ragged_m: M not a multiple of the kernel's points per thread;
    unaligned: the coordinates start off a 16-byte boundary; unit_w: a
    spatial dim of 1 (the generic axis modes)."""
    g = torch.Generator(device=device).manual_seed(4)
    B, C, D, W, H, M = 2, 2, 9, 12, 10, 6000
    if layout == "ragged_m":
        M = 6001
    if layout == "unit_w":
        W = 1
    vol = torch.rand((B, C, D, W, H), generator=g, device=device).to(taps)
    scale = torch.tensor([D, W, H], dtype=torch.float32, device=device)
    coords = torch.rand((B, M, 3), generator=g, device=device) \
        * (scale + 6.0) - 3.0
    if kind == "integer":
        coords = torch.floor(coords)
    if layout == "unaligned":
        coords = _unaligned(coords)
    cot = torch.randn((B, C, M), generator=g, device=device)
    before = warp_coord_grad.launches
    got = warp_coord_grad(vol, coords, cot, border)
    torch.cuda.synchronize()
    assert warp_coord_grad.launches == before + 1
    want = warp_coord_grad_plain(vol, coords, cot, border)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("B,L,n", [(4, 56, 3 * 40 ** 3), (3, 7, 3 * 49 ** 3),
                                   (8, 5, 1001), (1, 3, 7),
                                   (9, 56, 3 * 24 ** 3), (30, 56, 3 * 24 ** 3),
                                   (30, 7, 1001), (1, 57, 3 * 24 ** 3),
                                   (8, 57, 3 * 20 ** 3), (4, 3, 3 * 20 ** 3),
                                   (2, 5, 3 * 20 ** 3), (9, 130, 4000)])
@pytest.mark.parametrize("layout", ["aligned", "unaligned_basis",
                                    "unaligned_cotangent"])
def test_pca_grad_kernel_matches_plain(device, B, L, n, layout):
    """L that the warps' row slices do not divide (3, 5, 7, 57, and 130,
    more rows than one grid row holds), B from 1 to 30, and a basis or a
    cotangent off a 16-byte boundary (the scalar path)."""
    g = torch.Generator(device=device).manual_seed(5)
    cot = torch.randn((B, n), generator=g, device=device)
    V = (torch.randn((L, n), generator=g, device=device) * 0.01).bfloat16()
    if layout == "unaligned_basis":
        V = _unaligned(V)
    if layout == "unaligned_cotangent":
        cot = _unaligned(cot)
    before = pca_grad.launches
    got = pca_grad(cot, V)
    torch.cuda.synchronize()
    assert pca_grad.launches == before + -(-B // MAX_CHUNK)
    want = pca_grad_plain(cot, V)
    assert torch.equal(got, got.bfloat16().float())
    torch.testing.assert_close(got, want, rtol=2.0 ** -8,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("B,L,n", [(4, 56, 3 * 40 ** 3), (9, 57, 1001)])
def test_pca_grad_kernel_is_deterministic(device, B, L, n):
    """No float atomics: two calls on the same inputs give the same bits."""
    g = torch.Generator(device=device).manual_seed(7)
    cot = torch.randn((B, n), generator=g, device=device)
    V = (torch.randn((L, n), generator=g, device=device) * 0.01).bfloat16()
    first = pca_grad(cot, V)
    second = pca_grad(cot, V)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _phi(g, B, shape, device):
    """(B, 3, *shape) normalized map: the identity plus a smooth
    displacement of up to ~4 voxels, a third of the points on integer
    pixel coordinates, and batch element 0's first and last planes far
    outside the volume."""
    import torch.nn.functional as F
    n = torch.tensor(shape, dtype=torch.float32, device=device)
    half = ((n - 1.0) * 0.5).clamp(min=0.5).view(1, 3, 1, 1, 1)
    axes = [torch.arange(s, dtype=torch.float32, device=device)
            for s in shape]
    ident = torch.stack(torch.meshgrid(*axes, indexing="ij"))[None]
    low = torch.randn((B, 3, 4, 4, 4), generator=g, device=device)
    pix = ident + F.interpolate(low, size=shape, mode="trilinear",
                                align_corners=True) * 4.0
    kink = torch.rand(pix.shape, generator=g, device=device) < 0.33
    pix = torch.where(kink, torch.floor(pix), pix)
    pix[0, :, 0] = 3.0 * max(shape)
    pix[0, :, -1] = -2.0 * max(shape)
    return (pix / half - 1.0).contiguous()


@pytest.mark.parametrize("case", ["serving_b1", "serving_b4", "serving_b9",
                                  "ragged_m", "unaligned", "unit_d",
                                  "unit_w"])
@pytest.mark.parametrize("taps", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("border", [False, True])
@pytest.mark.parametrize("scale_intensity", [False, True])
def test_warp_phi_kernels_match_plain(device, case, taps, border,
                                      scale_intensity):
    """Both warp kernels with phi in its (B, 3, D, W, H) layout (the path
    of warp_image) against their plain versions: the 160^3 serving shape
    with B = 1, 4 and 9; M = 6001 points, not a multiple of the kernels'
    points a thread; phi and the cotangent one float off a 16-byte
    boundary (the scalar paths); spatial dims of 1 (the quad and generic
    axis modes). Forward atol 1e-6, gradient atol 1e-5 * max|plain|."""
    g = torch.Generator(device=device).manual_seed(8)
    C, spatial, out_shape = 2, (9, 12, 10), (9, 12, 10)
    B = 2
    if case.startswith("serving"):
        B, C, spatial = int(case[len("serving_b"):]), 1, (160, 160, 160)
        out_shape = spatial
    elif case == "ragged_m":
        out_shape = (6001,)
    elif case == "unit_d":
        spatial = out_shape = (1, 12, 10)
    elif case == "unit_w":
        spatial = out_shape = (9, 1, 10)
    vol = torch.rand((B, C) + spatial, generator=g, device=device).to(taps)
    if case == "ragged_m":
        phi = torch.rand((B, 3) + out_shape, generator=g,
                         device=device) * 2.6 - 1.3
    else:
        phi = _phi(g, B, out_shape, device)
    cot = torch.randn((B, C) + out_shape, generator=g, device=device)
    if case == "unaligned":
        phi, cot = _unaligned(phi), _unaligned(cot)
    before = (warp_trilinear.launches, warp_coord_grad.launches)
    got = warp_trilinear(vol, phi, border, normalized=True,
                         scale_intensity=scale_intensity)
    got_grad = warp_coord_grad(vol, phi, cot, border, normalized=True,
                               scale_intensity=scale_intensity)
    torch.cuda.synchronize()
    assert (warp_trilinear.launches, warp_coord_grad.launches) == \
        (before[0] + 1, before[1] + 1)
    assert got.shape == (B, C) + out_shape
    assert got_grad.shape == phi.shape and got_grad.is_contiguous()
    torch.testing.assert_close(
        got, warp_trilinear_plain(vol, phi, border, normalized=True,
                                  scale_intensity=scale_intensity),
        atol=1e-6, rtol=0)
    want = warp_coord_grad_plain(vol, phi, cot, border, normalized=True,
                                 scale_intensity=scale_intensity)
    torch.testing.assert_close(got_grad, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
