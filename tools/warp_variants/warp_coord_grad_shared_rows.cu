// Variant of liftreg_tpu_torch/csrc/warp_trilinear.cu for
// tools/torch_grad_sweep.py: the coordinate gradient shares tap rows between
// a thread's points. Same entry points, same values bit for bit.
//
// A thread's kGradPts consecutive points of a smooth field usually share
// their oct starts in z and y and step by one in x. Then 4 rows of
// kGradPts + 1 taps (20 loads for 4 points) hold every point's 8 taps (32
// loads otherwise); the thread checks the starts and falls back to each
// point's own 8 taps when they do not line up (and always in the quad and
// generic modes).
// Trilinear warp on Hopper: out (B, C, M) = taps (B, C, D, W, H) sampled at
// pixel coordinates coords (B, M, 3), (z, y, x) order, align_corners=True.
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
// Bound: bytes. At the serving shape (B=4, C=1, 160^3, bf16 taps) it reads the
// coordinates (197 MB f32) and the taps (33 MB) and writes 66 MB: ~0.30 GB,
// ~0.09 ms at 3.35 TB/s. One thread computes one output position for all C
// channels: its coordinate triple is read once (neighbouring threads read
// neighbouring triples) and the 8 taps come from two neighbouring rows of two
// neighbouring planes, which a smooth field keeps within a few cache lines of
// the neighbouring threads' taps. The wrapper prepares the inputs in torch:
// the (image+1)/2 intensity shift cast to the tap type, and phi converted to
// pixel coordinates; reading phi here instead would save the coordinate
// buffer and is left to a later change.
//
// The second entry, liftreg_warp_coord_grad, is the coordinate gradient:
// dcoords (B, M, 3) = sum_c g[b,c,m] * d out[b,c,m] / d coords[b,m,:], for
// the cotangent g (B, C, M). It replaces the with_grad variant of the TPU
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
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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
// derivatives with respect to the (unclipped) coordinate. I is the index
// type: int64_t in the forward, int in the gradient.
template <typename I>
struct Axis {
  I i0, i1;
  float w0, w1, d0, d1;
};

template <typename I>
__device__ __forceinline__ I clamp_index(I k, I n) {
  return k < 0 ? 0 : (k > n - 1 ? n - 1 : k);
}

// mode (see the note above): 0 oct, 1 quad, 2 generic
template <typename I>
__device__ __forceinline__ Axis<I> axis_taps(float c, I n, int border,
                                             int mode) {
  float cg = 1.f;
  if (border && mode != 2) {
    const float hi = static_cast<float>(n - 1);
    cg = clip_grad(c, hi);
    c = fminf(fmaxf(c, 0.f), hi);
  }
  Axis<I> a;
  if (mode == 0) {
    const float s = fminf(fmaxf(floorf(c), 0.f), static_cast<float>(n - 2));
    const float t = c - s;
    const float y0 = 1.f - fabsf(t);
    const float y1 = 1.f - fabsf(t - 1.f);
    a.i0 = static_cast<I>(s);
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
  // from overflowing a 32-bit I for coordinates far outside
  const I k0 =
      static_cast<I>(fminf(fmaxf(z0, -2.f), static_cast<float>(n) + 1.f));
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

template <typename T, int MODES>
__global__ void __launch_bounds__(kThreads)
warp_trilinear_kernel(const T* __restrict__ taps,
                      const float* __restrict__ coords,
                      float* __restrict__ out, int64_t B, int64_t C,
                      int64_t D, int64_t W, int64_t H, int64_t M,
                      int border, int modes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B * M) return;
  const int64_t b = i / M;
  const int64_t m = i - b * M;

  const Axis<int64_t> z = axis_taps(__ldg(coords + 3 * i + 0), D, border,
                                    axis_mode<MODES>(modes, 0));
  const Axis<int64_t> y = axis_taps(__ldg(coords + 3 * i + 1), W, border,
                                    axis_mode<MODES>(modes, 1));
  const Axis<int64_t> x = axis_taps(__ldg(coords + 3 * i + 2), H, border,
                                    axis_mode<MODES>(modes, 2));
  const int64_t zo[2] = {z.i0 * W * H, z.i1 * W * H};
  const int64_t yo[2] = {y.i0 * H, y.i1 * H};
  const int64_t xo[2] = {x.i0, x.i1};
  const float wz[2] = {z.w0, z.w1}, wy[2] = {y.w0, y.w1}, wx[2] = {x.w0, x.w1};

  constexpr bool kOneBase = MODES == kAllOct && std::is_same<T, float>::value;
  const int64_t S = D * W * H;
  for (int64_t ch = 0; ch < C; ++ch) {
    const T* v = taps + (b * C + ch) * S;
    float acc = 0.f;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float w = __fmul_rn(__fmul_rn(wz[dz], wy[dy]), wx[dx]);
          // oct taps are consecutive; f32 taps read faster from one base
          // with constant offsets, bf16 taps from the per-axis offsets
          // (both measured on the H100)
          const int64_t at = kOneBase
                                 ? zo[0] + yo[0] + xo[0] + (dz * W + dy) * H + dx
                                 : zo[dz] + yo[dy] + xo[dx];
          const float tap = load_tap(v, at);
          acc = __fadd_rn(acc, __fmul_rn(tap, w));
        }
    out[(b * C + ch) * M + m] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* taps, const float* coords, float* out,
                   int64_t B, int64_t C, int64_t D, int64_t W, int64_t H,
                   int64_t M, int border, int modes, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((B * M + kThreads - 1) / kThreads);
  const T* t = static_cast<const T*>(taps);
  if (modes == kAllOct)
    warp_trilinear_kernel<T, kAllOct><<<blocks, kThreads, 0, stream>>>(
        t, coords, out, B, C, D, W, H, M, border, modes);
  else
    warp_trilinear_kernel<T, -1><<<blocks, kThreads, 0, stream>>>(
        t, coords, out, B, C, D, W, H, M, border, modes);
  return cudaGetLastError();
}

// The coordinate gradient's design (bound: bytes, ~0.46 GB at the serving
// shape, ~0.14 ms): a thread takes kGradPts consecutive points of one batch
// element (blockIdx.y), so that its coordinates, its cotangent and its
// dcoords move as 16-byte vectors (3 x float4 and 1 float4 per channel for 4
// points) and every load of the thread is in flight before the first tap is
// needed. Offsets inside one (b, c) volume are 32-bit (the wrapper checks
// D*W*H < 2^31), and the batch index costs no division. The 8 taps of a
// point are interpolated along x, then y, then z, carrying the weights and
// their derivatives together (34 operations instead of 72). When M is not a
// multiple of kGradPts or a pointer is not 16-byte aligned, the loads and
// stores go one float at a time, masked at the end of the row.
#ifndef LIFTREG_GRAD_POINTS
#define LIFTREG_GRAD_POINTS 4
#endif
#ifndef LIFTREG_GRAD_THREADS
#define LIFTREG_GRAD_THREADS 512
#endif
constexpr int kGradPts = LIFTREG_GRAD_POINTS;
constexpr int kGradThreads = LIFTREG_GRAD_THREADS;
// floats per vector access: 3*kGradPts coordinates and kGradPts cotangent
// values split into pieces of this width
constexpr int kGradVec = kGradPts % 4 == 0 ? 4 : (kGradPts % 2 == 0 ? 2 : 1);

template <int N>
__device__ __forceinline__ void load_floats(const float* p, float* out,
                                            int vec, int valid) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < N; k += kGradVec) {
      if constexpr (kGradVec == 4) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(p + k));
        out[k] = f.x; out[k + 1] = f.y; out[k + 2] = f.z; out[k + 3] = f.w;
      } else if constexpr (kGradVec == 2) {
        const float2 f = __ldg(reinterpret_cast<const float2*>(p + k));
        out[k] = f.x; out[k + 1] = f.y;
      } else {
        out[k] = __ldg(p + k);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = k < valid ? __ldg(p + k) : 0.f;
  }
}

template <int N>
__device__ __forceinline__ void store_floats(float* p, const float* v,
                                             int vec, int valid) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < N; k += kGradVec) {
      if constexpr (kGradVec == 4)
        *reinterpret_cast<float4*>(p + k) =
            make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
      else if constexpr (kGradVec == 2)
        *reinterpret_cast<float2*>(p + k) = make_float2(v[k], v[k + 1]);
      else
        p[k] = v[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < valid) p[k] = v[k];
  }
}

template <typename T, int MODES>
__global__ void __launch_bounds__(kGradThreads)
warp_coord_grad_kernel(const T* __restrict__ taps,
                       const float* __restrict__ coords,
                       const float* __restrict__ g,
                       float* __restrict__ dcoords, int C, int D, int W,
                       int H, int M, int border, int modes, int vec) {
  const int b = blockIdx.y;
  const int m0 = (blockIdx.x * kGradThreads + threadIdx.x) * kGradPts;
  if (m0 >= M) return;
  const int valid = M - m0 < kGradPts ? M - m0 : kGradPts;
  const int64_t row = static_cast<int64_t>(b) * M;  // (b, 0) in (B, M)
  const int S = D * W * H;
  const int WH = W * H;

  float c[3 * kGradPts];
  load_floats<3 * kGradPts>(coords + 3 * (row + m0), c, vec, 3 * valid);
  float grad[3 * kGradPts];
#pragma unroll
  for (int k = 0; k < 3 * kGradPts; ++k) grad[k] = 0.f;

  for (int ch = 0; ch < C; ++ch) {
    const int64_t vc = static_cast<int64_t>(b) * C + ch;
    const T* v = taps + vc * S;
    float gc[kGradPts];
    load_floats<kGradPts>(g + vc * M + m0, gc, vec, valid);
    // every point's axes first, then its taps: shared rows when the points'
    // oct starts agree in z and y and step by one in x, else its own
    Axis<int> z[kGradPts], y[kGradPts], x[kGradPts];
#pragma unroll
    for (int p = 0; p < kGradPts; ++p) {
      // a masked point reads coordinate 0, whose taps lie in the volume
      z[p] = axis_taps(c[3 * p + 0], D, border, axis_mode<MODES>(modes, 0));
      y[p] = axis_taps(c[3 * p + 1], W, border, axis_mode<MODES>(modes, 1));
      x[p] = axis_taps(c[3 * p + 2], H, border, axis_mode<MODES>(modes, 2));
    }
    float tp[kGradPts][8];
    bool shared = MODES == kAllOct;
#pragma unroll
    for (int p = 1; p < kGradPts; ++p)
      shared = shared && z[p].i0 == z[0].i0 && y[p].i0 == y[0].i0 &&
               x[p].i0 == x[0].i0 + p;
    if (shared) {
      // 4 rows of kGradPts + 1 taps cover the kGradPts points' 8 taps each
      const int base = (z[0].i0 * W + y[0].i0) * H + x[0].i0;
      float rowv[4][kGradPts + 1];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e <= kGradPts; ++e)
          rowv[r][e] = load_tap(v, base + (r >> 1) * WH + (r & 1) * H + e);
#pragma unroll
      for (int p = 0; p < kGradPts; ++p)
#pragma unroll
        for (int k = 0; k < 8; ++k) tp[p][k] = rowv[k >> 1][p + (k & 1)];
    } else {
#pragma unroll
      for (int p = 0; p < kGradPts; ++p) {
        const int zo[2] = {z[p].i0 * WH, z[p].i1 * WH};
        const int yo[2] = {y[p].i0 * H, y[p].i1 * H};
        const int xo[2] = {x[p].i0, x[p].i1};
#pragma unroll
        for (int k = 0; k < 8; ++k)
          tp[p][k] = load_tap(v, zo[k >> 2] + yo[(k >> 1) & 1] + xo[k & 1]);
      }
    }
#pragma unroll
    for (int p = 0; p < kGradPts; ++p) {
      const float* t = tp[p];
      const Axis<int>& zp = z[p];
      const Axis<int>& yp = y[p];
      const Axis<int>& xp = x[p];
      // along x: value and d/dx of each (z, y) row pair
      float X[4], DX[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        X[r] = fmaf(t[2 * r + 1], xp.w1, t[2 * r] * xp.w0);
        DX[r] = fmaf(t[2 * r + 1], xp.d1, t[2 * r] * xp.d0);
      }
      // along y, for each z plane
      float XY[2], DY[2], DXY[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        XY[a] = fmaf(X[2 * a + 1], yp.w1, X[2 * a] * yp.w0);
        DY[a] = fmaf(X[2 * a + 1], yp.d1, X[2 * a] * yp.d0);
        DXY[a] = fmaf(DX[2 * a + 1], yp.w1, DX[2 * a] * yp.w0);
      }
      const float sz = fmaf(XY[1], zp.d1, XY[0] * zp.d0);
      const float sy = fmaf(DY[1], zp.w1, DY[0] * zp.w0);
      const float sx = fmaf(DXY[1], zp.w1, DXY[0] * zp.w0);
      grad[3 * p + 0] = fmaf(gc[p], sz, grad[3 * p + 0]);
      grad[3 * p + 1] = fmaf(gc[p], sy, grad[3 * p + 1]);
      grad[3 * p + 2] = fmaf(gc[p], sx, grad[3 * p + 2]);
    }
  }
  store_floats<3 * kGradPts>(dcoords + 3 * (row + m0), grad, vec, 3 * valid);
}

template <typename T>
cudaError_t launch_grad(const void* taps, const float* coords, const float* g,
                        float* dcoords, int64_t B, int64_t C, int64_t D,
                        int64_t W, int64_t H, int64_t M, int border,
                        int modes, cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kGradThreads) * kGradPts;
  const dim3 grid(static_cast<unsigned>((M + per_block - 1) / per_block),
                  static_cast<unsigned>(B));
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(coords) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(dcoords);
  const int vec = M % kGradPts == 0 && ptrs % 16 == 0;
  const T* t = static_cast<const T*>(taps);
  const int c = static_cast<int>(C), d = static_cast<int>(D),
            w = static_cast<int>(W), h = static_cast<int>(H),
            m = static_cast<int>(M);
  if (modes == kAllOct)
    warp_coord_grad_kernel<T, kAllOct><<<grid, kGradThreads, 0, stream>>>(
        t, coords, g, dcoords, c, d, w, h, m, border, modes, vec);
  else if (modes == kQuadZ)
    warp_coord_grad_kernel<T, kQuadZ><<<grid, kGradThreads, 0, stream>>>(
        t, coords, g, dcoords, c, d, w, h, m, border, modes, vec);
  else
    warp_coord_grad_kernel<T, -1><<<grid, kGradThreads, 0, stream>>>(
        t, coords, g, dcoords, c, d, w, h, m, border, modes, vec);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// taps_bf16 selects bf16 taps (else f32); border selects border padding
// (else zeros); modes packs the three axes' modes, 2 bits each, z lowest
// (mode 0 needs that axis >= 2; the wrapper checks).
extern "C" int liftreg_warp_trilinear(const void* taps, int taps_bf16,
                                      const float* coords, float* out,
                                      int64_t B, int64_t C, int64_t D,
                                      int64_t W, int64_t H, int64_t M,
                                      int border, int modes, void* stream) {
  if (B * M == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps_bf16)
    return launch<__nv_bfloat16>(taps, coords, out, B, C, D, W, H, M, border,
                                 modes, s);
  return launch<float>(taps, coords, out, B, C, D, W, H, M, border, modes,
                       s);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
// g (B, C, M) is the cotangent of the forward's output, dcoords (B, M, 3)
// receives the coordinate gradient; other arguments as above. D*W*H, 3*M
// and C*M must lie below 2^31 and B below 65536 (the wrapper checks).
extern "C" int liftreg_warp_coord_grad(const void* taps, int taps_bf16,
                                       const float* coords, const float* g,
                                       float* dcoords, int64_t B, int64_t C,
                                       int64_t D, int64_t W, int64_t H,
                                       int64_t M, int border, int modes,
                                       void* stream) {
  if (B * M == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps_bf16)
    return launch_grad<__nv_bfloat16>(taps, coords, g, dcoords, B, C, D, W,
                                      H, M, border, modes, s);
  return launch_grad<float>(taps, coords, g, dcoords, B, C, D, W, H, M,
                            border, modes, s);
}
