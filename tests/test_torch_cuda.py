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
f32 roundings. The warp's image gradient (f32 taps) adds each tap's terms
with f32 atomics in an order that changes from call to call: against the
plain version, and between two calls, atol 1e-5 * max|plain| plus 1e-6 of
the sum of the tap's terms' magnitudes (a border tap that takes a whole
plane of points far outside sums ~25,600 terms, and the order of such a
sum moves it by ~1e-5 of its value). The PCA
backward rounds an f32 sum taken in another order to bf16: the kernel and
the plain version are each held against the f64 product, within half a
bf16 step of the exact sum plus 1e-5 of its largest value (held against
each other, a correct kernel can differ by a full step where the exact
sum lies at a rounding midpoint). The
projector's adjoint sums each view's tap pairs in another order than the
plain dense products: atol 1e-5 * max|plain|, rtol 1e-5, and a second call
gives the same bits (no float atomics); its plan equals the plain plan,
and the serving geometry takes none of its general path. LNCC on the card
with TF32 allowed for convolutions against the CPU (f32 box sums in another
order): the value rtol 1e-5, atol 1e-6; the gradient rtol 1e-4, atol 1e-4 *
max|CPU| (TF32 sums would be off by ~1e-3). The gather probes repeat the
plain versions' sums in the same order, without fused multiply-adds and
with bf16 rounded where the plain bf16 arithmetic rounds: bit-equal."""
import pytest
import torch

from liftreg_tpu_torch.ops import drr
from liftreg_tpu_torch.losses.similarity import lncc_loss
from liftreg_tpu_torch.ops.drr_kernel import (backproject_taps,
                                              backproject_taps_plain,
                                              lift_encoder_input,
                                              project_adjoint_plan,
                                              project_adjoint_plan_plain,
                                              project_adjoint_taps,
                                              project_adjoint_taps_plain,
                                              project_taps,
                                              project_taps_plain)
from liftreg_tpu_torch.ops import gather_probe
from liftreg_tpu_torch.ops.pca_kernel import (MAX_CHUNK, pca_expand,
                                              pca_expand_plain, pca_grad,
                                              pca_grad_plain)
from liftreg_tpu_torch.ops.warp_kernel import (warp_coord_grad,
                                               warp_coord_grad_plain,
                                               image_grad_overflow,
                                               warp_image_grad,
                                               warp_image_grad_plain,
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
    moving = torch.rand((B, 1) + tuple(vol_shape), generator=g,
                        device=device)
    buf = lift_encoder_input(moving, proj, u_pix, v_pix,
                             dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert backproject_taps.launches == before + 2
    assert torch.equal(buf[:, 1:], got.bfloat16())
    assert torch.equal(buf[:, :1], moving.bfloat16())


def _sorted_pix(g, shape, n, device, integer=False):
    """Edge coordinates (``_edge_pix``) or integers from -2 to n + 1,
    sorted along the detector axis, as poses make them: rising rows."""
    if integer:
        pix = torch.randint(-2, n + 2, shape, generator=g,
                            device=device).float()
    else:
        pix = _edge_pix(g, shape, n, device)
    return pix.sort(dim=-1).values.contiguous()


@pytest.mark.parametrize("B,vol_shape,res", DRR_SHAPES
                         + [(1, (160, 160, 160), (240, 240))])
@pytest.mark.parametrize("views", [3, 4])
@pytest.mark.parametrize("geometry", ["poses", "edges", "integer", "falling",
                                      "unordered"])
def test_drr_adjoint_kernel_matches_plain(device, geometry, views, B,
                                          vol_shape, res):
    """The adjoint kernel against its plain version: the projector's
    shapes and B = 1 at the serving shape; coordinates from poses, sorted
    edge values, sorted integers, edge values in falling order, and (off
    the serving shape: the kernel's general path then reads whole rows) in
    no order. Two calls, with the plan given and without, give the same
    bits; the plan equals the plain plan; rows in no order take the
    general path, the serving poses never."""
    if geometry == "unordered" and vol_shape[0] == 160:
        pytest.skip("rows in no order cost the kernel whole rows a voxel: "
                    "run at the small shapes")
    g = torch.Generator(device=device).manual_seed(9)
    D, W, H = vol_shape
    cot = torch.randn((B, views) + res, generator=g, device=device)
    poses = torch.from_numpy(drr.synthesize_poses(30.0, views, W)).to(device)
    x_pix, z_pix, dx = drr.forward_geometry(poses, (D, W, H), res,
                                            (2.2, 2.0, 2.4))
    if geometry in ("edges", "integer"):
        x_pix = _sorted_pix(g, tuple(x_pix.shape), D, device,
                            geometry == "integer")
        z_pix = _sorted_pix(g, tuple(z_pix.shape), H, device,
                            geometry == "integer")
    elif geometry == "falling":
        x_pix = _sorted_pix(g, tuple(x_pix.shape), D, device).flip(-1)
        z_pix = _sorted_pix(g, tuple(z_pix.shape), H, device).flip(-1)
    elif geometry == "unordered":
        x_pix = _edge_pix(g, tuple(x_pix.shape), D, device)
        z_pix = _edge_pix(g, tuple(z_pix.shape), H, device)
    x_pix, z_pix = x_pix.contiguous(), z_pix.contiguous()
    plan = project_adjoint_plan(x_pix, z_pix, vol_shape)
    general = torch.zeros(1, dtype=torch.int32, device=device)
    before = project_adjoint_taps.launches
    got = project_adjoint_taps(cot, x_pix, z_pix, dx, vol_shape, plan=plan,
                               general_tiles=general)
    again = project_adjoint_taps(cot, x_pix, z_pix, dx, vol_shape)
    torch.cuda.synchronize()
    assert project_adjoint_taps.launches == before + 2
    assert got.shape == (B, D, W, H)
    assert torch.equal(got, again)
    assert torch.equal(plan, project_adjoint_plan_plain(x_pix, z_pix,
                                                        vol_shape))
    if geometry == "unordered":
        assert int(general.item()) > 0
    if geometry == "poses" and vol_shape[0] == 160:
        assert int(general.item()) == 0
    want = project_adjoint_taps_plain(cot, x_pix, z_pix, dx, vol_shape)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


# (name, B, (D, W, H), detector, views, rows in no order in views [a, b)):
# more views than the kernel stages at once (9: three groups), at a small
# shape and at the serving shape; three batch groups (B = 9); a shape whose
# D, W and H are multiples of neither the tile nor the plane chunk; a
# detector narrower than the volume's shadow (runs end at its edges); and a
# middle view group in no order between two ordered ones (general path,
# then the fast path adding onto its sums)
ADJOINT_CASES = [
    ("views9", 2, (20, 17, 22), (30, 27), 9, None),
    ("views9_serving", 4, (160, 160, 160), (240, 240), 9, None),
    ("batch9", 9, (24, 33, 20), (37, 29), 4, None),
    ("ragged", 3, (37, 29, 41), (53, 47), 4, None),
    ("narrow_detector", 4, (48, 20, 64), (30, 40), 4, None),
    ("views9_middle_unordered", 5, (20, 17, 22), (30, 27), 9, (4, 8)),
]


@pytest.mark.parametrize("name,B,vol_shape,res,views,unordered",
                         ADJOINT_CASES, ids=[c[0] for c in ADJOINT_CASES])
def test_drr_adjoint_kernel_view_groups_batches_and_edges(
        device, name, B, vol_shape, res, views, unordered):
    """The adjoint kernel against its plain version (atol 1e-5 *
    max|plain|, rtol 1e-5) where its staging and its tiles meet their
    limits; two calls give the same bits. Geometry from poses, which take
    no general path at the serving shape."""
    g = torch.Generator(device=device).manual_seed(11)
    D, W, H = vol_shape
    cot = torch.randn((B, views) + res, generator=g, device=device)
    poses = torch.from_numpy(drr.synthesize_poses(30.0, views, W)).to(device)
    x_pix, z_pix, dx = drr.forward_geometry(poses, vol_shape, res,
                                            (2.2, 2.2, 2.2))
    if unordered is not None:
        a, b = unordered
        x_pix[a:b] = _edge_pix(g, tuple(x_pix[a:b].shape), D, device)
        z_pix[a:b] = _edge_pix(g, tuple(z_pix[a:b].shape), H, device)
    plan = project_adjoint_plan(x_pix, z_pix, vol_shape)
    general = torch.zeros(1, dtype=torch.int32, device=device)
    got = project_adjoint_taps(cot, x_pix, z_pix, dx, vol_shape, plan=plan,
                               general_tiles=general)
    again = project_adjoint_taps(cot, x_pix, z_pix, dx, vol_shape, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(plan, project_adjoint_plan_plain(x_pix, z_pix,
                                                        vol_shape))
    if unordered is not None:
        assert int(general.item()) > 0
    if D == 160:
        assert int(general.item()) == 0
    want = project_adjoint_taps_plain(cot, x_pix, z_pix, dx, vol_shape)
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_drr_adjoint_wrapper_rejects_a_wrong_plan(device):
    x_pix = torch.zeros((2, 5, 7), device=device)
    z_pix = torch.zeros((2, 5, 6), device=device)
    dx = torch.ones((2, 7, 6), device=device)
    g = torch.zeros((1, 2, 7, 6), device=device)
    plan = project_adjoint_plan(x_pix, z_pix, (4, 5, 3))
    with pytest.raises(ValueError):
        project_adjoint_taps(g, x_pix, z_pix, dx, (4, 5, 4), plan=plan)
    with pytest.raises(ValueError):
        project_adjoint_taps(g, x_pix, z_pix, dx, (4, 5, 3),
                             plan=plan.long())
    with pytest.raises(ValueError):
        project_adjoint_taps(g, x_pix, z_pix, dx, (4, 5, 3), plan=plan,
                             general_tiles=torch.zeros(1, device=device))


def test_lncc_keeps_f32_box_sums_with_tf32_allowed(device):
    """lncc_loss on the card with TF32 allowed for convolutions (PyTorch's
    default), value and gradient against the CPU."""
    g = torch.Generator().manual_seed(10)
    x = torch.rand((2, 1, 40, 36, 44), generator=g) * 2.0 - 1.0
    y = 0.6 * x + 0.4 * (torch.rand(x.shape, generator=g) * 2.0 - 1.0)
    opts = {"smooth": 3, "scales": [1, 2]}
    results = {}
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for where in ("cpu", "cuda"):
            xt = x.detach().to(where).requires_grad_(True)
            loss = lncc_loss(xt, y.to(where), **opts)
            loss.backward()
            results[where] = (loss.detach().cpu(), xt.grad.cpu())
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    torch.testing.assert_close(results["cuda"][0], results["cpu"][0],
                               rtol=1e-5, atol=1e-6)
    want = results["cpu"][1]
    torch.testing.assert_close(results["cuda"][1], want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


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
    exact = cot.double() @ V.double().T
    # half a bf16 step at each exact value: |x| = m 2^e, m in [0.5, 1)
    half_step = torch.ldexp(torch.ones_like(exact),
                            torch.frexp(exact).exponent - 9)
    slack = 1e-5 * float(exact.abs().max())
    for name, t in (("kernel", got), ("plain", want)):
        excess = float(((t.double() - exact).abs() - half_step - slack).max())
        assert excess <= 0, (name, excess)


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


def _tf32_flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


def test_model_alone_keeps_f32_with_tf32_on(device):
    """C5: the caller turns TF32 on for the process, then builds the model
    alone (no pipeline) in f32 on the card: its output agrees with the CPU
    at the pipeline's f32 tolerance (phi atol 1e-5, warped atol 1e-4; TF32
    convolutions would be off by ~1e-3), and the caller's flags are the
    same after each call."""
    from liftreg_tpu_torch.models import LiftRegSubspaceBackproj
    sz, P, L = (32, 32, 32), 4, 8
    g = torch.Generator().manual_seed(11)
    inputs = {"source": torch.rand((2, 1) + sz, generator=g) * 2 - 1,
              "target": torch.rand((2, 1) + sz, generator=g) * 2 - 1,
              "target_proj": torch.rand((2, P, 48, 48), generator=g) * 2 - 1,
              "target_poses": torch.from_numpy(
                  drr.synthesize_poses(30.0, P, sz[1]))}
    pca = {"vectors": torch.randn((L, 3 * 32 ** 3), generator=g) * 0.01,
           "mean": torch.randn((3 * 32 ** 3,), generator=g) * 0.01}
    torch.manual_seed(11)
    model = LiftRegSubspaceBackproj(sz, latent_dim=L, drr_feature_num=P)
    saved = _tf32_flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        caller = _tf32_flags()
        outs = {}
        for where in ("cpu", "cuda"):
            m = LiftRegSubspaceBackproj(sz, latent_dim=L, drr_feature_num=P)
            m.load_state_dict(model.state_dict())
            m.to(where)
            with torch.no_grad():
                out = m({k: v.to(where) for k, v in inputs.items()},
                        {k: v.to(where) for k, v in pca.items()})
            torch.cuda.synchronize()
            assert _tf32_flags() == caller
            outs[where] = {k: out[k].cpu() for k in ("phi", "warped")}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
    torch.testing.assert_close(outs["cuda"]["phi"], outs["cpu"]["phi"],
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(outs["cuda"]["warped"], outs["cpu"]["warped"],
                               atol=1e-4, rtol=0)


def test_f32_artifact_keeps_f32_with_tf32_on(device, tmp_path):
    """A serving artifact of the f32 pipeline, exported and served on the
    card while the caller has TF32 on for convolutions and products: the
    served call equals the live pipeline on the card bit for bit and agrees
    with the CPU at the pipeline's f32 tolerance (phi atol 1e-5, warped
    atol 1e-4; TF32 convolutions would be off by ~1e-3); the caller's flags
    are the same after the call. The exported graph does not keep
    ``f32_precision``: ``ServingModel`` runs every call under it."""
    from liftreg_tpu_torch import RegistrationPipeline
    from liftreg_tpu_torch.serving import ServingModel, export_serving
    sz, L, B = (32, 32, 32), 8, 2
    g = torch.Generator().manual_seed(12)
    pca = {"vectors": torch.randn((L, 3 * 32 ** 3), generator=g) * 0.01,
           "mean": torch.randn((3 * 32 ** 3,), generator=g) * 0.01}
    args = [torch.rand((B, 1) + sz, generator=g) * -1000.0 for _ in "st"]
    args += [(torch.rand((B, 1) + sz, generator=g) > 0.4).float()] * 2
    torch.manual_seed(12)
    pipes = {w: RegistrationPipeline(sz, latent_dim=L, device=w)
             for w in ("cpu", "cuda")}
    pipes["cuda"].model.load_state_dict(pipes["cpu"].model.state_dict())
    card_pca = {k: v.to(device) for k, v in pca.items()}
    path = export_serving(pipes["cuda"], card_pca, B,
                          str(tmp_path / "f32.liftreg"))
    srv = ServingModel.load(path)
    saved = _tf32_flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        caller = _tf32_flags()
        card_args = [a.to(device) for a in args]
        served = srv.register(*card_args)
        live = pipes["cuda"].register(card_pca, *card_args)
        torch.cuda.synchronize()
        assert _tf32_flags() == caller
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
    cpu = pipes["cpu"].register(pca, *args)
    for a, b in zip(served, live):
        assert torch.equal(a, b)
    torch.testing.assert_close(served[1].cpu(), cpu[1], atol=1e-5, rtol=0)
    torch.testing.assert_close(served[0].cpu(), cpu[0], atol=1e-4, rtol=0)


def test_train_step_on_card_matches_cpu(device, tmp_path):
    """One train step of RegistrationTrainer at 32^3 (B = 2, latent 4,
    2 views, f32) on the card against the same step on the CPU from the
    same parameters: the losses atol 1e-5, the parameters after the step
    atol 1e-5 (Adam's first step moves each weight by about lr = 1e-3, so
    a gradient's f32 differences reach the weights only where it is near
    0, and a gradient wrong in magnitude not at all), Adam's moments after
    the step (mu = 0.1 g, nu = 0.001 g^2: the gradient itself) within 1e-2
    of each leaf's largest value (the card's lift geometry rounds
    otherwise, and the first convolution's gradient, whose sums cancel,
    carries that further than the other leaves),
    with the launches of one step: the lift,
    the warp and its coordinate gradient once each, no PCA kernel (f32
    basis)."""
    import os
    from liftreg_tpu_torch.train import RegistrationTrainer
    from torch_train_data import setting, write_dataset
    os.environ["LIFTREG_NO_TB"] = "1"
    root = write_dataset(str(tmp_path / "data"), sz=32, n_train=2, n_val=1)
    cpu = RegistrationTrainer(setting(str(root), str(tmp_path / "cpu"),
                                      sz=32), device="cpu")
    init = cpu.save_model("init", is_best=False)
    card = RegistrationTrainer(setting(str(root), str(tmp_path / "card"),
                                       sz=32, init_params_from=init))
    kernels = (backproject_taps, warp_trilinear, warp_coord_grad,
               pca_expand, pca_grad, project_taps)
    results = {}
    for name, tr in (("cpu", cpu), ("cuda", card)):
        batch, names = next(iter(tr._iter_device("train", 0)))
        before = [k.launches for k in kernels]
        losses = tr._train_step(batch, tr.loss.factor(0), len(names))
        torch.cuda.synchronize()
        launches = [k.launches - b for k, b in zip(kernels, before)]
        results[name] = ({k: float(v) for k, v in losses.items()},
                         {k: p.detach().cpu() for k, p in tr.params.items()},
                         {m: {k: v.cpu() for k, v in tr.opt_state[m].items()}
                          for m in ("mu", "nu")})
    assert launches == [1, 1, 1, 0, 0, 0]
    for m, leaves in results["cpu"][2].items():
        for k, want in leaves.items():
            err = float((results["cuda"][2][m][k] - want).abs().max())
            assert err <= 1e-2 * float(want.abs().max()), (m, k, err)
    for k in ("total_loss", "sim_loss", "reg_loss"):
        assert abs(results["cuda"][0][k] - results["cpu"][0][k]) <= 1e-5, k
    for k, want in results["cpu"][1].items():
        torch.testing.assert_close(results["cuda"][1][k], want, atol=1e-5,
                                   rtol=0)


IMAGE_GRAD_CASES = ("serving_c1_b1", "serving_c3_b1", "serving_c1_b2",
                    "serving_c3_b2", "ragged_m", "unaligned", "unit_d",
                    "unit_w", "unit_h", "pixel", "rough", "pixel_rough",
                    "faces", "pixel_faces")


@pytest.mark.parametrize("case,border,scale_intensity", [
    (case, border, scale) for case in IMAGE_GRAD_CASES
    for border in (False, True) for scale in (False, True)
    # the pixel layout has no scale_intensity
    if not (case == "pixel" and scale)])
def test_warp_image_grad_kernel_matches_plain(device, case, border,
                                              scale_intensity):
    """The image gradient (f32 taps) against its plain version: C = 1 and 3
    at 160^3 with B = 1 and 2 in the phi layout; M = 6001 points, which no
    block divides; phi and the cotangent off a 16-byte boundary; spatial
    dims of 1 (the quad and generic modes); the pixel layout (no rescale
    there). Coordinates far outside, on integers and on the edges. A rough
    field (each point up to 12 voxels off its own, independently), whose
    tiles' boxes overflow the kernel's shared memory and take its overflow
    path, which must then count points; a field clamped onto the faces, so
    that the tiles' boxes end exactly at them. Two calls agree within the
    same tolerance (see the module docstring)."""
    g = torch.Generator(device=device).manual_seed(9)
    B, C, spatial, out_shape = 2, 2, (9, 12, 10), (9, 12, 10)
    if case.startswith("serving"):
        C, B = int(case[len("serving_c")]), int(case[-1])
        spatial = out_shape = (160, 160, 160)
    elif case == "ragged_m":
        out_shape = (6001,)
    elif case.startswith("unit"):
        axis = "dwh".index(case[-1])
        spatial = out_shape = tuple(1 if i == axis else n
                                    for i, n in enumerate(spatial))
    elif case.endswith(("rough", "faces")):
        C, spatial = 3, (40, 24, 36)
        out_shape = spatial
    vol = torch.zeros((B, C) + spatial, device=device)
    if case == "ragged_m":
        phi = torch.rand((B, 3) + out_shape, generator=g,
                         device=device) * 2.6 - 1.3
    else:
        phi = _phi(g, B, out_shape, device)
    if case.endswith(("rough", "faces")):
        n = torch.tensor(spatial, dtype=torch.float32,
                         device=device).view(1, 3, 1, 1, 1)
        pix = (phi + 1.0) * (n - 1.0) * 0.5
        if case.endswith("rough"):
            pix = pix + (torch.rand(pix.shape, generator=g,
                                    device=device) * 24.0 - 12.0)
        else:
            pix = torch.minimum(torch.maximum(pix, torch.zeros_like(pix)),
                                n - 1.0)
        phi = (pix / ((n - 1.0) * 0.5) - 1.0).contiguous()
    cot = torch.randn((B, C) + out_shape, generator=g, device=device)
    if case == "unaligned":
        phi, cot = _unaligned(phi), _unaligned(cot)
    flags = {"normalized": True, "scale_intensity": scale_intensity}
    if case.startswith("pixel"):
        n = torch.tensor(spatial, dtype=torch.float32, device=device)
        phi = ((phi.movedim(1, -1) + 1.0) * (n - 1) * 0.5).reshape(
            B, -1, 3).contiguous()
        cot = cot.reshape(B, C, -1).contiguous()
        flags = {}
    before = warp_image_grad.launches
    overflow = image_grad_overflow(device)
    overflow.zero_()
    got = warp_image_grad(vol, phi, cot, border, **flags)
    again = warp_image_grad(vol, phi, cot, border, **flags)
    torch.cuda.synchronize()
    assert warp_image_grad.launches == before + 2
    assert got.shape == vol.shape
    if case.endswith("rough"):
        assert int(overflow) > 0
    want = warp_image_grad_plain(vol, phi, cot, border, **flags)
    mag = warp_image_grad_plain(vol, phi, cot.abs(), border, **flags)
    tol = 1e-5 * float(want.abs().max()) + 1e-6 * mag
    assert bool(((got - want).abs() <= tol).all())
    assert bool(((again - got).abs() <= tol).all())


@pytest.mark.parametrize("case", ["serving", "unit_d", "unit_w", "pixel",
                                  "rough"])
@pytest.mark.parametrize("border", [False, True])
def test_warp_image_grad_bf16_taps_kernel_matches_plain(device, case,
                                                        border):
    """bf16 taps (the oct weights on every axis): the kernel's f32 sums,
    cast to bf16 once, against the plain version's. The f32 sums agree
    within the f32 tolerance above, and their bf16 roundings then within
    one more bf16 step (at most 2^-7 of the value, where a rounding
    midpoint lies between them)."""
    g = torch.Generator(device=device).manual_seed(10)
    B, C, spatial = 2, 1, (40, 24, 36)
    if case == "serving":
        spatial = (160, 160, 160)
    elif case.startswith("unit"):
        axis = "dwh".index(case[-1])
        spatial = tuple(1 if i == axis else n for i, n in enumerate(spatial))
    vol = torch.zeros((B, C) + spatial, device=device, dtype=torch.bfloat16)
    phi = _phi(g, B, spatial, device)
    if case == "rough":
        phi = (phi + torch.rand(phi.shape, generator=g, device=device)
               * 0.5 - 0.25).contiguous()
    cot = torch.randn((B, C) + spatial, generator=g, device=device)
    flags = {"normalized": True, "scale_intensity": True}
    if case == "pixel":
        n = torch.tensor(spatial, dtype=torch.float32, device=device)
        phi = ((phi.movedim(1, -1) + 1.0) * (n - 1) * 0.5).reshape(
            B, -1, 3).contiguous()
        cot = cot.reshape(B, C, -1).contiguous()
        flags = {}
    before = warp_image_grad.launches
    got = warp_image_grad(vol, phi, cot, border, **flags)
    torch.cuda.synchronize()
    assert warp_image_grad.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == vol.shape
    want = warp_image_grad_plain(vol, phi, cot, border, **flags).float()
    mag = warp_image_grad_plain(vol.float(), phi, cot.abs(), border,
                                **flags)
    tol = (1e-5 * float(want.abs().max()) + 1e-6 * mag
           + 2.0 ** -7 * want.abs())
    assert bool(((got.float() - want).abs() <= tol).all())


def test_warp_image_grad_zero_padding_adds_nothing(device):
    """Points far outside under zeros padding reach no tap: exactly 0."""
    vol = torch.zeros((1, 3, 8, 9, 10), device=device)
    pix = torch.tensor([[[40.0, 50.0, -30.0], [-9.0, 8.0, 4.0],
                         [4.0, -1.0, 100.0], [8.5, 4.0, 4.0]]],
                       device=device)
    got = warp_image_grad(vol, pix, torch.ones((1, 3, 4), device=device),
                          False)
    assert int(torch.count_nonzero(got)) == 0


def _probe_indices(kind, shape, n, inner, g, device):
    """int32 indices of ``shape`` for a probe whose gathered axis has n
    elements: ``int32`` draws from the whole int32 range, with 0, n - 1
    and INT32_MAX among them; ``wrap`` picks from the indices where the
    kernels' index walk turns: INT32_MAX - inner + 1 .. INT32_MAX (where
    idx + k wraps to INT32_MIN), INT32_MIN, INT32_MIN + 1, -1, -n and
    n - 1."""
    if kind == "int32":
        idx = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                            device=device, dtype=torch.int32)
        idx.view(-1)[:3] = torch.tensor([0, n - 1, 2 ** 31 - 1])
        return idx
    special = torch.tensor([2 ** 31 - 1 - t for t in range(inner)]
                           + [-2 ** 31, -2 ** 31 + 1, -1, -n, n - 1],
                           dtype=torch.int32, device=device)
    pick = torch.randint(0, len(special), shape, generator=g, device=device)
    return special[pick]


def _probe_bit_equal(probe, x, idx, inner, grid):
    """One launch of wrapper ``probe``, counted, bit-equal to its plain
    version."""
    fn = getattr(gather_probe, probe)
    before = fn.launches
    got = fn(x, inner, grid) if probe == "roll_sum" else fn(x, idx, inner,
                                                            grid)
    want = gather_probe.plain_version(probe, x, idx, inner)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.dtype == x.dtype and torch.equal(
        got.float().view(torch.int32), want.float().view(torch.int32))


@pytest.mark.parametrize("probe", ["gather_lanes", "gather_rows",
                                   "roll_sum", "warp_step"])
@pytest.mark.parametrize("shape", [(8, 128), (160, 160), (37, 45),
                                   (1280, 128), (160, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inner,grid", [(1, 1), (8, 3), (15, 1), (64, 1),
                                        (64, 2)])
@pytest.mark.parametrize("indices", ["int32", "wrap"])
def test_gather_probe_matches_plain(device, probe, shape, dtype, inner,
                                    grid, indices):
    """Each probe kernel against its plain version, bit for bit, on
    indices over the whole int32 range (the floor modulo at negative
    indices and ``idx + k`` wrapping) with 0 and M - 1 among them, and on
    the indices where the kernels' index walk turns; inner 64 runs past
    n at (8, 128), and grid 1 at (160, 128) splits a band's rows over
    several blocks."""
    g = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(shape, generator=g, device=device).to(dtype)
    n = shape[1] if probe == "gather_lanes" else shape[0]
    idx = _probe_indices(indices, shape, n, inner, g, device)
    _probe_bit_equal(probe, x, idx, inner, grid)


@pytest.mark.parametrize("probe,shape,dtype", [
    ("gather_rows", (2048, 64), torch.bfloat16),
    ("warp_step", (3632, 33), torch.bfloat16),
    ("gather_rows", (1812, 64), torch.bfloat16),
    ("gather_rows", (1816, 32), torch.float32),
    ("warp_step", (1809, 40), torch.float32),
    ("gather_lanes", (1, 58111), torch.float32),
    ("roll_sum", (1, 58112), torch.float32),
    ("gather_lanes", (3, 19370), torch.float32),
    ("roll_sum", (2, 58000), torch.bfloat16)])
@pytest.mark.parametrize("grid", [1, 2])
def test_gather_probe_at_the_shared_memory_edge(device, probe, shape, dtype,
                                                grid):
    """Tiles whose band only just fits a block are still taken, bit-equal:
    a bf16 row gather with 1816 < M <= 3632 keeps the 32-column band (its
    64-column one would not fit), and bands that leave no room for the
    wrapped copies of rows or columns run without them."""
    if probe in ("gather_rows", "warp_step"):
        op = gather_probe.ROWS
        assert gather_probe.band_columns(shape[0], dtype) == (
            32 if dtype == torch.float32 or shape[0] > 1816 else 64)
    else:
        op = gather_probe.LANES
    assert gather_probe.band_bytes(op, shape, dtype) <= gather_probe.SMEM_BYTES
    g = torch.Generator(device=device).manual_seed(5)
    x = torch.randn(shape, generator=g, device=device).to(dtype)
    n = shape[1] if probe == "gather_lanes" else shape[0]
    idx = _probe_indices("wrap", shape, n, 9, g, device)
    _probe_bit_equal(probe, x, idx, 9, grid)


def test_gather_probe_refuses_a_band_past_shared_memory(device):
    """A row band (M * 32 elements) or a lane band (8 rows) that does not
    fit a block's shared memory is refused before any launch."""
    x = torch.zeros((2048, 64), device=device)
    idx = torch.zeros((2048, 64), dtype=torch.int32, device=device)
    before = gather_probe.gather_rows.launches
    with pytest.raises(ValueError, match="shared"):
        gather_probe.gather_rows(x, idx, 1)
    wide = torch.zeros((8, 8192), device=device)
    with pytest.raises(ValueError, match="shared"):
        gather_probe.roll_sum(wide, 1)
    assert gather_probe.gather_rows.launches == before
