// Trilinear warp on Hopper: out (B, C, M) = taps (B, C, D, W, H) sampled at
// M points per batch element, align_corners=True. The points come in one of
// two layouts:
//   pixel (liftreg_warp_trilinear): coords (B, M, 3), pixel coordinates in
//     (z, y, x) order, grid_sample's points of any output shape;
//   phi (liftreg_warp_trilinear_phi): phi (B, 3, M), normalized [-1, 1]
//     coordinates with channel c indexing spatial axis c, warp_image's map
//     read where it lies. The kernel makes each pixel coordinate in
//     registers as (p + 1) * f32((n - 1) / 2), rounded after the add and
//     after the multiply as the torch and JAX glue round it, and with
//     rescale returns out * 2 - 1 (scale_intensity's way back to [-1, 1]),
//     rounded as torch rounds it. No coordinate buffer is built.
// One templated kernel body serves both layouts.
//
// Replaces liftreg_tpu/ops/pallas_warp.py:_warp_plane_kernel (its
// pallas_call in _plane_impl, reached through warp_plane_gather /
// warp_plane_sample) in its forward form. The semantics are those of
// liftreg_tpu/ops/resample.py:_oct_plain: border padding clips the
// coordinate to [0, n-1] first; each start is clip(floor(c), 0, n-2); the
// weights are relu(1-|t|) and relu(1-|t-1|) with t = c - start, so zeros
// padding falls out of vanishing weights; weights and the sum are f32, and the
// 8 corners are summed in (dz, dy, dx) order with no fused multiply-add, as
// the reference sums them. Unlike the TPU kernel, which is exact only inside
// its (dy_max, dx_max) window, this kernel is exact for any field.
//
// Each axis has a mode, chosen by the wrapper from the volume's shape as
// liftreg_tpu/ops/resample.py:grid_sample routes it (:517-527), so that a
// spatial dim of 1 samples and differentiates as the JAX package does:
//   0 (oct): start clip(floor(c), 0, n-2), relu-hat weights, as above;
//      needs n >= 2;
//   1 (quad): k0 = floor(c), weights (1 - f, f) with f = c - k0, times the
//      zeros padding mask of each tap, indices clipped to [0, n-1]; border
//      padding clips the coordinate first (resample._trilinear_quad's z);
//   2 (generic): as 1, but border padding does not clip the coordinate, only
//      the indices (resample.py's generic gather path, taken when W or H
//      is 1).
// A volume with W, H >= 2 takes mode 0 on y and x; its z takes mode 1 when
// D = 1 (and, in the gradient, for f32 taps), else 0. W or H = 1 takes mode 2
// on every axis.
//
// Bound: bytes. At the serving shape (B=4, C=1, 160^3, bf16 taps) it reads phi
// (197 MB f32) and the taps (33 MB) and writes 66 MB: ~0.30 GB, ~0.088 ms at
// 3.35 TB/s. A thread takes kPts points of one batch element (blockIdx.y: no
// division), 32 apart: a warp covers 32 * kPts consecutive points, one a lane
// in each load, so that every gather of a tap reads 32 neighbouring taps
// (one or two cache lines) and every load of phi and store of the output
// is 128 contiguous bytes, while the thread keeps 8 * kPts tap loads in
// flight. Offsets inside one (b, c) volume are 32-bit (the wrapper checks the
// shape). Measured on the H100 (tools/torch_warp_sweep.py): 4 points with
// bf16 taps, 2 with f32 (64 and 32 registers), 256 threads. Consecutive
// points with 16-byte vectors (LIFTREG_WARP_STRIDED=0) were slower: a
// gather then spans 4 times the cache lines. So were L2 cache hints (phi and
// the output evict-first, the taps evict-last; the 33 MB of taps stay in the
// 50 MB L2 without them) and the x pair of bf16 taps as one 32-bit load
// (the parity of x0 alternates between neighbouring lanes, so a warp takes
// both paths). Those three are knobs of
// tools/warp_variants/warp_trilinear_knobs.cu.
//
// The second entry, liftreg_warp_coord_grad (pixel layout) and
// liftreg_warp_coord_grad_phi (phi layout), is the coordinate gradient:
// dcoords (B, M, 3) = sum_c g[b,c,m] * d out[b,c,m] / d coords[b,m,:], for
// the cotangent g (B, C, M); in the phi layout g is doubled under rescale
// (exact) and the kernel writes dphi (B, 3, M) = dcoords * f32((n - 1) / 2)
// per axis, rounded once, as autograd of the glue gives it. It replaces the
// with_grad variant of the TPU
// kernel (pallas_warp.py:_warp_plane_kernel with with_grad=True, reached
// through warp_plane_sample's custom VJP) by gathering the 8 taps again
// rather than storing the per-channel residual (197 MB at the serving
// shape). At a kink it follows the path the refinement differentiates in the
// JAX package, XLA autodiff of resample.warp_image, and not the TPU kernel's
// own where(w > 0, -sign(t), 0):
//   d|t|/dt = +1 at t = 0; d max(0, y)/dy = 1/2 at y = 0; d clip/dc = 1/2 at
//   either bound of border padding;
//   mode 0 (resample._oct_plain, and y and x of _trilinear_quad): the
//   relu-hat weights' derivatives under those rules;
//   modes 1 and 2 (the z axis of _trilinear_quad for f32 taps, and the
//   generic path): d/dc is (-mask0, +mask1) even at integers, times the
//   clip's derivative in mode 1 with border padding; in mode 2 a border
//   coordinate outside [0, n-1] gets two equal indices, so its terms cancel.
// Bound: bytes, as the forward plus the cotangent and dcoords (~0.46 GB at
// the serving shape, ~0.14 ms).
//
// The third entry, liftreg_warp_image_grad (pixel layout) and
// liftreg_warp_image_grad_phi (phi layout), is the gradient with respect to
// the taps, for f32 taps: dtaps (B, C, D, W, H) += g[b,c,m] * w_k(m) at the
// 8 taps tap_k(m) of each point, with the forward's taps and weights (the
// same per-axis modes, clips and zeros padding masks; the phi layout makes
// the pixel coordinates in registers and doubles g under rescale, as the
// coordinate gradient does). The TPU kernel has no counterpart: its
// with_grad variant returns NaN for the image (pallas_warp.py:305-311). It
// ports XLA's scatter-add in the autodiff of resample._quad_plain
// (resample.py:91-145), the path that RegNet2D3D differentiates, and sums
// each tap's term as (g * w_z) * (w_y * w_x), as that autodiff rounds it.
// The wrapper zero-fills dtaps; one thread takes one point of one batch
// element (blockIdx.y) and adds its terms of nonzero weight, up to 8 per
// channel, with f32 atomics (red.global.add.f32), so the order of a tap's
// sum changes from run to run (and a tap of weight 0 takes no term, where
// XLA's scatter adds g * 0: the two differ only for a non-finite g).
// Bound: bytes, phi, the cotangent and dtaps (~0.15 GB at C = 3, 160^3,
// B = 1, ~0.044 ms); the atomics set the time instead: 0.405 ms there on an
// H100 80GB HBM3 at 700 W, against 0.453 for grid_sampler_3d_backward's
// input gradient (chip_smoke.py times). Hopper's vector
// red.global.add.v2/v4.f32 and a deterministic gather design are untried.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// the forward's compile-time knobs (tools/torch_warp_sweep.py): points a
// thread with bf16 and with f32 taps, threads a block
#ifndef LIFTREG_WARP_POINTS
#define LIFTREG_WARP_POINTS 4
#endif
#ifndef LIFTREG_WARP_POINTS_F32
#define LIFTREG_WARP_POINTS_F32 2
#endif
#ifndef LIFTREG_WARP_THREADS
#define LIFTREG_WARP_THREADS 256
#endif

namespace {

// layouts of the sample points (see the note above)
constexpr int kPixel = 0;
constexpr int kPhi = 1;

// V consecutive floats at p (16-byte aligned for V = 4)
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (V == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
  } else if constexpr (V == 2) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = f.x; out[1] = f.y;
  } else {
    out[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    p[0] = v[0];
}

// N floats at p: as 16-byte (or 8-byte) vectors when vec, else one at a
// time, the first `valid` of them (the rest read 0)
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float* out,
                                            int vec, int valid) {
  constexpr int V = N % 4 == 0 ? 4 : (N % 2 == 0 ? 2 : 1);
  if (vec) {
#pragma unroll
    for (int k = 0; k < N; k += V) load_vec<V>(p + k, out + k);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = k < valid ? __ldg(p + k) : 0.f;
  }
}

template <int N>
__device__ __forceinline__ void store_floats(float* p, const float* v,
                                             int vec, int valid) {
  constexpr int V = N % 4 == 0 ? 4 : (N % 2 == 0 ? 2 : 1);
  if (vec) {
#pragma unroll
    for (int k = 0; k < N; k += V) store_vec<V>(p + k, v + k);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < valid) p[k] = v[k];
  }
}

// The points m0 .. m0 + PTS - 1 of batch element b (of M) as pixel
// coordinates, c[3 * p + axis]; scale[axis] is f32((n - 1) / 2) of the
// volume. A masked point reads 0, which lies in the volume in either layout.
template <int LAYOUT, int PTS>
__device__ __forceinline__ void load_points(const float* src, int b, int m0,
                                            int M, int valid, int vec,
                                            const float* scale, float* c) {
  if constexpr (LAYOUT == kPixel) {
    load_floats<3 * PTS>(src + 3 * (static_cast<int64_t>(b) * M + m0), c, vec,
                         3 * valid);
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float p[PTS];
      load_floats<PTS>(src + (static_cast<int64_t>(b) * 3 + a) * M + m0, p,
                       vec, valid);
#pragma unroll
      for (int k = 0; k < PTS; ++k)
        c[3 * k + a] = __fmul_rn(__fadd_rn(p[k], 1.f), scale[a]);
    }
  }
}

// The same for the points m + 32 * p (p < PTS) of batch element b: one point
// a lane, so that a warp's loads of one plane read 32 consecutive floats
template <int LAYOUT, int PTS>
__device__ __forceinline__ void load_points_strided(const float* src, int b,
                                                    int m, int M,
                                                    const float* scale,
                                                    float* c) {
#pragma unroll
  for (int p = 0; p < PTS; ++p) {
    const int mp = m + 32 * p;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float* at =
          LAYOUT == kPixel ? src + 3 * (static_cast<int64_t>(b) * M + mp) + a
                           : src + (static_cast<int64_t>(b) * 3 + a) * M + mp;
      const float v = mp < M ? __ldg(at) : 0.f;
      c[3 * p + a] =
          LAYOUT == kPixel ? v : __fmul_rn(__fadd_rn(v, 1.f), scale[a]);
    }
  }
}

// The gradient of the points' coordinates, v[3 * p + axis], in the layout of
// the points: dcoords (B, M, 3), or dphi (B, 3, M) = dcoords * scale
template <int LAYOUT, int PTS>
__device__ __forceinline__ void store_points(float* dst, int b, int m0,
                                             int M, int valid, int vec,
                                             const float* scale,
                                             const float* v) {
  if constexpr (LAYOUT == kPixel) {
    store_floats<3 * PTS>(dst + 3 * (static_cast<int64_t>(b) * M + m0), v,
                          vec, 3 * valid);
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float d[PTS];
#pragma unroll
      for (int k = 0; k < PTS; ++k) d[k] = __fmul_rn(v[3 * k + a], scale[a]);
      store_floats<PTS>(dst + (static_cast<int64_t>(b) * 3 + a) * M + m0, d,
                        vec, valid);
    }
  }
}

template <typename I>
__device__ __forceinline__ float load_tap(const float* p, I i) {
  return __ldg(p + i);
}

template <typename I>
__device__ __forceinline__ float load_tap(const __nv_bfloat16* p, I i) {
  return __bfloat162float(p[i]);
}

// d clip(c, 0, n-1) / dc under JAX's convention (1/2 at either bound)
__device__ __forceinline__ float clip_grad(float c, float hi) {
  if (c > 0.f && c < hi) return 1.f;
  return (c == 0.f || c == hi) ? 0.5f : 0.f;
}

// d max(0, y) / dy with 1/2 at the tie, and d|t|/dt with +1 at 0
__device__ __forceinline__ float relu_grad(float y) {
  return y > 0.f ? 1.f : (y == 0.f ? 0.5f : 0.f);
}

__device__ __forceinline__ float abs_grad(float t) {
  return t >= 0.f ? 1.f : -1.f;
}

// One axis of the warp: the two tap indices, their weights and the weights'
// derivatives with respect to the (unclipped) coordinate.
struct Axis {
  int i0, i1;
  float w0, w1, d0, d1;
};

__device__ __forceinline__ int clamp_index(int k, int n) {
  return k < 0 ? 0 : (k > n - 1 ? n - 1 : k);
}

// mode (see the note above): 0 oct, 1 quad, 2 generic
__device__ __forceinline__ Axis axis_taps(float c, int n, int border,
                                          int mode) {
  float cg = 1.f;
  if (border && mode != 2) {
    const float hi = static_cast<float>(n - 1);
    cg = clip_grad(c, hi);
    c = fminf(fmaxf(c, 0.f), hi);
  }
  Axis a;
  if (mode == 0) {
    const float s = fminf(fmaxf(floorf(c), 0.f), static_cast<float>(n - 2));
    const float t = c - s;
    const float y0 = 1.f - fabsf(t);
    const float y1 = 1.f - fabsf(t - 1.f);
    a.i0 = static_cast<int>(s);
    a.i1 = a.i0 + 1;
    a.w0 = fmaxf(0.f, y0);
    a.w1 = fmaxf(0.f, y1);
    a.d0 = -abs_grad(t) * relu_grad(y0) * cg;
    a.d1 = -abs_grad(t - 1.f) * relu_grad(y1) * cg;
    return a;
  }
  const float z0 = floorf(c);
  const float f = c - z0;
  // k0 only matters inside [-1, n], so the clamp is exact and keeps k0 + 1
  // from overflowing for coordinates far outside
  const int k0 =
      static_cast<int>(fminf(fmaxf(z0, -2.f), static_cast<float>(n) + 1.f));
  const float m0 = (border || (k0 >= 0 && k0 <= n - 1)) ? 1.f : 0.f;
  const float m1 = (border || (k0 + 1 >= 0 && k0 + 1 <= n - 1)) ? 1.f : 0.f;
  a.i0 = clamp_index(k0, n);
  a.i1 = clamp_index(k0 + 1, n);
  a.w0 = (1.f - f) * m0;
  a.w1 = f * m1;
  a.d0 = -m0 * cg;
  a.d1 = m1 * cg;
  return a;
}

// MODES >= 0 fixes the packed modes at compile time (the common volumes:
// every axis oct, or z quad for the gradient of f32 taps); -1 reads them at
// run time
template <int MODES>
__device__ __forceinline__ int axis_mode(int modes, int d) {
  return ((MODES >= 0 ? MODES : modes) >> (2 * d)) & 3;
}

constexpr int kAllOct = 0;
constexpr int kQuadZ = 1;

// The offsets of a point's 8 taps in (dz, dy, dx) order inside one (b, c)
// volume: oct taps are neighbours (one base and constant offsets), the
// other modes add per-axis offsets
template <int MODES>
__device__ __forceinline__ void tap_offsets(const Axis& z, const Axis& y,
                                            const Axis& x, int W, int H,
                                            int* at) {
  const int WH = W * H;
  if constexpr (MODES == kAllOct) {
    const int base = (z.i0 * W + y.i0) * H + x.i0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      at[k] = base + (k >> 2) * WH + ((k >> 1) & 1) * H + (k & 1);
  } else {
    const int zo[2] = {z.i0 * WH, z.i1 * WH};
    const int yo[2] = {y.i0 * H, y.i1 * H};
    const int xo[2] = {x.i0, x.i1};
#pragma unroll
    for (int k = 0; k < 8; ++k)
      at[k] = zo[k >> 2] + yo[(k >> 1) & 1] + xo[k & 1];
  }
}

// The 8 taps of a point in (dz, dy, dx) order: oct taps are neighbours, read
// as 4 x pairs from row pointers off one base (8 index sums and their
// 64-bit addresses instead measured 10-40% slower on the H100); the other
// modes from per-axis offsets
template <int MODES, typename T>
__device__ __forceinline__ void gather_taps(const T* v, const Axis& z,
                                            const Axis& y, const Axis& x,
                                            int W, int H, float* t) {
  const int WH = W * H;
  if constexpr (MODES == kAllOct) {
    const T* r = v + (z.i0 * W + y.i0) * H + x.i0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const T* row = r + (k >> 1) * WH + (k & 1) * H;
      t[2 * k] = load_tap(row, 0);
      t[2 * k + 1] = load_tap(row, 1);
    }
  } else {
    const int zo[2] = {z.i0 * WH, z.i1 * WH};
    const int yo[2] = {y.i0 * H, y.i1 * H};
    const int xo[2] = {x.i0, x.i1};
#pragma unroll
    for (int k = 0; k < 8; ++k)
      t[k] = load_tap(v, zo[k >> 2] + yo[(k >> 1) & 1] + xo[k & 1]);
  }
}

// points a thread for taps of type T
template <typename T>
constexpr int kWarpPtsOf = std::is_same<T, float>::value
                               ? LIFTREG_WARP_POINTS_F32
                               : LIFTREG_WARP_POINTS;
constexpr int kWarpThreads = LIFTREG_WARP_THREADS;

template <typename T, int MODES, int LAYOUT>
__global__ void __launch_bounds__(kWarpThreads)
warp_trilinear_kernel(const T* __restrict__ taps,
                      const float* __restrict__ pts,
                      float* __restrict__ out, int C, int D, int W, int H,
                      int M, int border, int modes, int rescale) {
  constexpr int kPts = kWarpPtsOf<T>;
  const int b = blockIdx.y;
  // a thread's points: m0, m0 + 32, ..., with m0 its lane in its warp's
  // 32 * kPts consecutive points
  const int lane = threadIdx.x & 31;
  const int m0 = (blockIdx.x * kWarpThreads + threadIdx.x - lane) * kPts + lane;
  if (m0 >= M) return;
  const int S = D * W * H;
  const float scale[3] = {0.5f * static_cast<float>(D - 1),
                          0.5f * static_cast<float>(W - 1),
                          0.5f * static_cast<float>(H - 1)};

  float c[3 * kPts];
  load_points_strided<LAYOUT, kPts>(pts, b, m0, M, scale, c);
  Axis z[kPts], y[kPts], x[kPts];
#pragma unroll
  for (int p = 0; p < kPts; ++p) {
    z[p] = axis_taps(c[3 * p + 0], D, border, axis_mode<MODES>(modes, 0));
    y[p] = axis_taps(c[3 * p + 1], W, border, axis_mode<MODES>(modes, 1));
    x[p] = axis_taps(c[3 * p + 2], H, border, axis_mode<MODES>(modes, 2));
  }

  for (int ch = 0; ch < C; ++ch) {
    const int64_t vc = static_cast<int64_t>(b) * C + ch;
    const T* v = taps + vc * S;
    float acc[kPts];
#pragma unroll
    for (int p = 0; p < kPts; ++p) {
      float t[8];
      gather_taps<MODES>(v, z[p], y[p], x[p], W, H, t);
      const float wz[2] = {z[p].w0, z[p].w1}, wy[2] = {y[p].w0, y[p].w1},
                  wx[2] = {x[p].w0, x[p].w1};
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float w =
            __fmul_rn(__fmul_rn(wz[k >> 2], wy[(k >> 1) & 1]), wx[k & 1]);
        a = __fadd_rn(a, __fmul_rn(t[k], w));
      }
      acc[p] = rescale ? __fsub_rn(__fmul_rn(a, 2.f), 1.f) : a;
    }
#pragma unroll
    for (int p = 0; p < kPts; ++p)
      if (m0 + 32 * p < M) out[vc * M + m0 + 32 * p] = acc[p];
  }
}

template <typename T, int LAYOUT>
cudaError_t launch(const void* taps, const float* pts, float* out, int64_t B,
                   int64_t C, int64_t D, int64_t W, int64_t H, int64_t M,
                   int border, int modes, int rescale, cudaStream_t stream) {
  const int64_t per_block =
      static_cast<int64_t>(kWarpThreads) * kWarpPtsOf<T>;
  const dim3 grid(static_cast<unsigned>((M + per_block - 1) / per_block),
                  static_cast<unsigned>(B));
  const T* t = static_cast<const T*>(taps);
  const int c = static_cast<int>(C), d = static_cast<int>(D),
            w = static_cast<int>(W), h = static_cast<int>(H),
            m = static_cast<int>(M);
  if (modes == kAllOct)
    warp_trilinear_kernel<T, kAllOct, LAYOUT>
        <<<grid, kWarpThreads, 0, stream>>>(t, pts, out, c, d, w, h, m,
                                            border, modes, rescale);
  else
    warp_trilinear_kernel<T, -1, LAYOUT><<<grid, kWarpThreads, 0, stream>>>(
        t, pts, out, c, d, w, h, m, border, modes, rescale);
  return cudaGetLastError();
}

// The coordinate gradient's design (bound: bytes, ~0.46 GB at the serving
// shape, ~0.14 ms): a thread takes kGradPts consecutive points of one batch
// element (blockIdx.y), so that its coordinates (or phi planes), its
// cotangent and its gradient move as 16-byte vectors (3 x float4 and 1
// float4 per channel for 4 points) and every load of the thread is in
// flight before the first tap is needed. Offsets inside one (b, c) volume
// are 32-bit (the wrapper checks D*W*H < 2^31), and the batch index costs no
// division. The 8 taps of a point are interpolated along x, then y, then z,
// carrying the weights and their derivatives together (34 operations
// instead of 72). When M is not a multiple of kGradPts or a pointer is not
// 16-byte aligned, the loads and stores go one float at a time, masked at
// the end of the row. 4 points and 512 threads measured fastest on the H100;
// 1, 2 or 8 points, other block sizes and tap rows shared by a thread's
// points were slower (tools/torch_grad_sweep.py, tools/warp_variants/).
// Two blocks an SM cap the registers at 64: left alone, the compiler gives
// the phi layout 95-128 and the kernel then takes ~0.26 ms instead of ~0.19.
#ifndef LIFTREG_GRAD_POINTS
#define LIFTREG_GRAD_POINTS 4
#endif
#ifndef LIFTREG_GRAD_THREADS
#define LIFTREG_GRAD_THREADS 512
#endif
// blocks an SM must hold (caps the registers)
#ifndef LIFTREG_GRAD_MIN_BLOCKS
#define LIFTREG_GRAD_MIN_BLOCKS 2
#endif
constexpr int kGradPts = LIFTREG_GRAD_POINTS;
constexpr int kGradThreads = LIFTREG_GRAD_THREADS;

template <typename T, int MODES, int LAYOUT>
__global__ void __launch_bounds__(kGradThreads, LIFTREG_GRAD_MIN_BLOCKS)
warp_coord_grad_kernel(const T* __restrict__ taps,
                       const float* __restrict__ pts,
                       const float* __restrict__ g,
                       float* __restrict__ dpts, int C, int D, int W, int H,
                       int M, int border, int modes, int rescale, int vec) {
  const int b = blockIdx.y;
  const int m0 = (blockIdx.x * kGradThreads + threadIdx.x) * kGradPts;
  if (m0 >= M) return;
  const int valid = M - m0 < kGradPts ? M - m0 : kGradPts;
  const int S = D * W * H;
  const float scale[3] = {0.5f * static_cast<float>(D - 1),
                          0.5f * static_cast<float>(W - 1),
                          0.5f * static_cast<float>(H - 1)};

  float c[3 * kGradPts];
  load_points<LAYOUT, kGradPts>(pts, b, m0, M, valid, vec, scale, c);
  float grad[3 * kGradPts];
#pragma unroll
  for (int k = 0; k < 3 * kGradPts; ++k) grad[k] = 0.f;

  for (int ch = 0; ch < C; ++ch) {
    const int64_t vc = static_cast<int64_t>(b) * C + ch;
    const T* v = taps + vc * S;
    float gc[kGradPts];
    load_floats<kGradPts>(g + vc * M + m0, gc, vec, valid);
    if (rescale) {
      // d(out * 2 - 1)/d out, exact
#pragma unroll
      for (int p = 0; p < kGradPts; ++p) gc[p] *= 2.f;
    }
#pragma unroll
    for (int p = 0; p < kGradPts; ++p) {
      // a masked point reads coordinate 0, whose taps lie in the volume
      const Axis z =
          axis_taps(c[3 * p + 0], D, border, axis_mode<MODES>(modes, 0));
      const Axis y =
          axis_taps(c[3 * p + 1], W, border, axis_mode<MODES>(modes, 1));
      const Axis x =
          axis_taps(c[3 * p + 2], H, border, axis_mode<MODES>(modes, 2));
      int at[8];
      tap_offsets<MODES>(z, y, x, W, H, at);
      float t[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) t[k] = load_tap(v, at[k]);
      // along x: value and d/dx of each (z, y) row pair
      float X[4], DX[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        X[r] = fmaf(t[2 * r + 1], x.w1, t[2 * r] * x.w0);
        DX[r] = fmaf(t[2 * r + 1], x.d1, t[2 * r] * x.d0);
      }
      // along y, for each z plane
      float XY[2], DY[2], DXY[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        XY[a] = fmaf(X[2 * a + 1], y.w1, X[2 * a] * y.w0);
        DY[a] = fmaf(X[2 * a + 1], y.d1, X[2 * a] * y.d0);
        DXY[a] = fmaf(DX[2 * a + 1], y.w1, DX[2 * a] * y.w0);
      }
      const float sz = fmaf(XY[1], z.d1, XY[0] * z.d0);
      const float sy = fmaf(DY[1], z.w1, DY[0] * z.w0);
      const float sx = fmaf(DXY[1], z.w1, DXY[0] * z.w0);
      grad[3 * p + 0] = fmaf(gc[p], sz, grad[3 * p + 0]);
      grad[3 * p + 1] = fmaf(gc[p], sy, grad[3 * p + 1]);
      grad[3 * p + 2] = fmaf(gc[p], sx, grad[3 * p + 2]);
    }
  }
  store_points<LAYOUT, kGradPts>(dpts, b, m0, M, valid, vec, scale, grad);
}

template <typename T, int LAYOUT>
cudaError_t launch_grad(const void* taps, const float* pts, const float* g,
                        float* dpts, int64_t B, int64_t C, int64_t D,
                        int64_t W, int64_t H, int64_t M, int border,
                        int modes, int rescale, cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kGradThreads) * kGradPts;
  const dim3 grid(static_cast<unsigned>((M + per_block - 1) / per_block),
                  static_cast<unsigned>(B));
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(pts) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(dpts);
  const int vec = M % kGradPts == 0 && ptrs % 16 == 0;
  const T* t = static_cast<const T*>(taps);
  const int c = static_cast<int>(C), d = static_cast<int>(D),
            w = static_cast<int>(W), h = static_cast<int>(H),
            m = static_cast<int>(M);
  if (modes == kAllOct)
    warp_coord_grad_kernel<T, kAllOct, LAYOUT>
        <<<grid, kGradThreads, 0, stream>>>(t, pts, g, dpts, c, d, w, h, m,
                                            border, modes, rescale, vec);
  else if (modes == kQuadZ)
    warp_coord_grad_kernel<T, kQuadZ, LAYOUT>
        <<<grid, kGradThreads, 0, stream>>>(t, pts, g, dpts, c, d, w, h, m,
                                            border, modes, rescale, vec);
  else
    warp_coord_grad_kernel<T, -1, LAYOUT><<<grid, kGradThreads, 0, stream>>>(
        t, pts, g, dpts, c, d, w, h, m, border, modes, rescale, vec);
  return cudaGetLastError();
}

// The image gradient's design (see the note at the top): one thread a
// point, the channels in a loop, up to 8 f32 atomics a channel.
constexpr int kImgThreads = 256;

template <int MODES, int LAYOUT>
__global__ void __launch_bounds__(kImgThreads)
warp_image_grad_kernel(const float* __restrict__ pts,
                       const float* __restrict__ g,
                       float* __restrict__ dtaps, int C, int D, int W, int H,
                       int M, int border, int modes, int rescale) {
  const int b = blockIdx.y;
  const int m = blockIdx.x * kImgThreads + threadIdx.x;
  if (m >= M) return;
  const int S = D * W * H;
  const float scale[3] = {0.5f * static_cast<float>(D - 1),
                          0.5f * static_cast<float>(W - 1),
                          0.5f * static_cast<float>(H - 1)};
  float c[3];
  load_points_strided<LAYOUT, 1>(pts, b, m, M, scale, c);
  const Axis z = axis_taps(c[0], D, border, axis_mode<MODES>(modes, 0));
  const Axis y = axis_taps(c[1], W, border, axis_mode<MODES>(modes, 1));
  const Axis x = axis_taps(c[2], H, border, axis_mode<MODES>(modes, 2));
  int at[8];
  tap_offsets<MODES>(z, y, x, W, H, at);
  const float wz[2] = {z.w0, z.w1};
  const float wyx[4] = {__fmul_rn(y.w0, x.w0), __fmul_rn(y.w0, x.w1),
                        __fmul_rn(y.w1, x.w0), __fmul_rn(y.w1, x.w1)};
  // a tap of weight 0 (masked, clipped, or t on an integer) adds nothing:
  // skipping its atomic changes no finite sum, and keeps the points
  // outside a zeros-padded volume off the taps they are clipped to
  bool live[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) live[k] = wz[k >> 2] != 0.f && wyx[k & 3] != 0.f;
  for (int ch = 0; ch < C; ++ch) {
    const int64_t vc = static_cast<int64_t>(b) * C + ch;
    float gv = __ldg(g + vc * M + m);
    // d(out * 2 - 1)/d out, exact
    if (rescale) gv *= 2.f;
    float* d = dtaps + vc * S;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (live[k])
        atomicAdd(d + at[k],
                  __fmul_rn(__fmul_rn(gv, wz[k >> 2]), wyx[k & 3]));
  }
}

template <int LAYOUT>
int image_grad(const float* pts, const float* g, float* dtaps, int64_t B,
               int64_t C, int64_t D, int64_t W, int64_t H, int64_t M,
               int border, int modes, int rescale, void* stream) {
  if (B * M == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((M + kImgThreads - 1) / kImgThreads),
                  static_cast<unsigned>(B));
  const int c = static_cast<int>(C), d = static_cast<int>(D),
            w = static_cast<int>(W), h = static_cast<int>(H),
            m = static_cast<int>(M);
  if (modes == kAllOct)
    warp_image_grad_kernel<kAllOct, LAYOUT><<<grid, kImgThreads, 0, s>>>(
        pts, g, dtaps, c, d, w, h, m, border, modes, rescale);
  else if (modes == kQuadZ)
    warp_image_grad_kernel<kQuadZ, LAYOUT><<<grid, kImgThreads, 0, s>>>(
        pts, g, dtaps, c, d, w, h, m, border, modes, rescale);
  else
    warp_image_grad_kernel<-1, LAYOUT><<<grid, kImgThreads, 0, s>>>(
        pts, g, dtaps, c, d, w, h, m, border, modes, rescale);
  return static_cast<int>(cudaGetLastError());
}

template <int LAYOUT>
int warp(const void* taps, int taps_bf16, const float* pts, float* out,
         int64_t B, int64_t C, int64_t D, int64_t W, int64_t H, int64_t M,
         int border, int modes, int rescale, void* stream) {
  if (B * M == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps_bf16)
    return launch<__nv_bfloat16, LAYOUT>(taps, pts, out, B, C, D, W, H, M,
                                         border, modes, rescale, s);
  return launch<float, LAYOUT>(taps, pts, out, B, C, D, W, H, M, border,
                               modes, rescale, s);
}

template <int LAYOUT>
int coord_grad(const void* taps, int taps_bf16, const float* pts,
               const float* g, float* dpts, int64_t B, int64_t C, int64_t D,
               int64_t W, int64_t H, int64_t M, int border, int modes,
               int rescale, void* stream) {
  if (B * M == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps_bf16)
    return launch_grad<__nv_bfloat16, LAYOUT>(taps, pts, g, dpts, B, C, D, W,
                                              H, M, border, modes, rescale,
                                              s);
  return launch_grad<float, LAYOUT>(taps, pts, g, dpts, B, C, D, W, H, M,
                                    border, modes, rescale, s);
}

}  // namespace

// Each entry launches on `stream` without synchronising and returns
// cudaGetLastError(). taps_bf16 selects bf16 taps (else f32); border selects
// border padding (else zeros); modes packs the three axes' modes, 2 bits
// each, z lowest (mode 0 needs that axis >= 2). D*W*H and M + 2^16 must lie
// below 2^31 and B below 65536 (the wrapper checks all of it).
extern "C" int liftreg_warp_trilinear(const void* taps, int taps_bf16,
                                      const float* coords, float* out,
                                      int64_t B, int64_t C, int64_t D,
                                      int64_t W, int64_t H, int64_t M,
                                      int border, int modes, void* stream) {
  return warp<kPixel>(taps, taps_bf16, coords, out, B, C, D, W, H, M, border,
                      modes, 0, stream);
}

// phi (B, 3, M) normalized; rescale returns out * 2 - 1
extern "C" int liftreg_warp_trilinear_phi(const void* taps, int taps_bf16,
                                          const float* phi, float* out,
                                          int64_t B, int64_t C, int64_t D,
                                          int64_t W, int64_t H, int64_t M,
                                          int border, int modes, int rescale,
                                          void* stream) {
  return warp<kPhi>(taps, taps_bf16, phi, out, B, C, D, W, H, M, border,
                    modes, rescale, stream);
}

// g (B, C, M) is the cotangent of the forward's output, dcoords (B, M, 3)
// receives the coordinate gradient
extern "C" int liftreg_warp_coord_grad(const void* taps, int taps_bf16,
                                       const float* coords, const float* g,
                                       float* dcoords, int64_t B, int64_t C,
                                       int64_t D, int64_t W, int64_t H,
                                       int64_t M, int border, int modes,
                                       void* stream) {
  return coord_grad<kPixel>(taps, taps_bf16, coords, g, dcoords, B, C, D, W,
                            H, M, border, modes, 0, stream);
}

// the same for phi (B, 3, M): dphi (B, 3, M), g doubled under rescale
extern "C" int liftreg_warp_coord_grad_phi(const void* taps, int taps_bf16,
                                           const float* phi, const float* g,
                                           float* dphi, int64_t B, int64_t C,
                                           int64_t D, int64_t W, int64_t H,
                                           int64_t M, int border, int modes,
                                           int rescale, void* stream) {
  return coord_grad<kPhi>(taps, taps_bf16, phi, g, dphi, B, C, D, W, H, M,
                          border, modes, rescale, stream);
}

// The gradient with respect to f32 taps: dtaps (B, C, D, W, H), zero-filled
// by the caller, receives sum over points of g (B, C, M) times each tap's
// weight at coords (B, M, 3)
extern "C" int liftreg_warp_image_grad(const float* coords, const float* g,
                                       float* dtaps, int64_t B, int64_t C,
                                       int64_t D, int64_t W, int64_t H,
                                       int64_t M, int border, int modes,
                                       void* stream) {
  return image_grad<kPixel>(coords, g, dtaps, B, C, D, W, H, M, border,
                            modes, 0, stream);
}

// the same for phi (B, 3, M), g doubled under rescale
extern "C" int liftreg_warp_image_grad_phi(const float* phi, const float* g,
                                           float* dtaps, int64_t B, int64_t C,
                                           int64_t D, int64_t W, int64_t H,
                                           int64_t M, int border, int modes,
                                           int rescale, void* stream) {
  return image_grad<kPhi>(phi, g, dtaps, B, C, D, W, H, M, border, modes,
                          rescale, stream);
}
