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
// The wrapper zero-fills dtaps. Bound: bytes, phi, the cotangent and dtaps
// (~0.15 GB at C = 3, 160^3, B = 1, ~0.044 ms). A first version (one
// thread a point, each term a red.global.add.f32: ~98 M global atomics at
// that shape) took 0.399-0.405 ms there on an H100 80GB HBM3 at 700 W. This
// design sums in shared memory instead: a block owns a tile of output
// points (1 x 8 x 32 of a 3-D phi, a warp's lanes on consecutive x; else a
// run of consecutive points), finds the box of its points' live taps (a
// min/max over warp reductions and shared atomics; taps of weight 0 stay
// out, so zeros-padded points far outside do not widen it), zeroes the box
// in shared memory, adds each live term there with a shared-memory f32
// atomic, and adds the box to dtaps once, row by row along x, as 16-byte
// red.global.add.v4.f32 where H % 4 == 0 (else one float at a time),
// skipping groups that stayed 0. A tile whose box times its channels
// overflows the budget (a rough field; border padding that clips points
// far outside onto a face) adds its terms to dtaps directly, in the same
// kernel, and its points are counted in the wrapper's overflow counter.
// Each term is still (g * w_z) * (w_y * w_x), and a tap of weight 0 takes
// none (where XLA's scatter adds g * 0: the two differ only for a
// non-finite g); only the order of a tap's sum changes, and it changes
// from run to run.
// Measured on an H100 80GB HBM3 at 700 W (C = 3, 160^3, B = 1, zero fill
// included), with 1 x 8 x 32 points, 256 threads, 5 blocks an SM, 6144
// floats and 3 channels' cotangents in registers: 0.305 ms on
// chip_smoke.py's smooth field of up to ~12 voxels against the first
// version's 0.400, 0.222 against 0.228 on a 0.9-voxel field, 0.176
// against 0.157 on the identity (its atomics meet no conflicts there), and
// for the 8 calls of one RegNet2D3D step 1.87 ms against 2.74 on noise
// inputs and 1.42 against 1.39 on smooth ones (tools/torch_kernel_ab.py,
// parent and change in turns). Sending the tiles near the identity
// straight to dtaps lost (those 8 noise-input calls replayed: 4.05 ms
// against 1.99), as did merging neighbouring points' terms in registers
// first (tools/warp_variants/warp_image_grad_merged.cuh) and other tiles,
// threads, budgets and channels (tools/torch_image_grad_sweep.py;
// PERF.md section 6).
#include <climits>
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

// The image gradient's design (see the note at the top): a block owns a tile
// of kImgTile output points, kImgPts a thread (in the phi layout with a 3-D
// out_shape a kImgTZ x kImgTY x kImgTX block of the output grid, x
// innermost and a warp's lanes on consecutive x, so that the loads of phi
// and g are coalesced; else a run of consecutive points). It finds the box
// of the tile's live taps, adds its points' terms into the box in shared
// memory with shared-memory atomics, and adds the box to dtaps once, row by
// row along x; a tile whose box overflows kImgSmemFloats adds its terms to
// dtaps directly. tools/torch_image_grad_sweep.py patches these constants.
constexpr int kImgTZ = 1;
constexpr int kImgTY = 8;
constexpr int kImgTX = 32;
constexpr int kImgThreads = 256;
// blocks an SM must hold (caps the registers)
constexpr int kImgMinBlocks = 5;
// the box's shared-memory budget in floats, for all channels of a pass
constexpr int kImgSmemFloats = 6144;
// channels of a pass whose cotangents a thread holds in registers
constexpr int kImgChan = 3;
constexpr int kImgTile = kImgTZ * kImgTY * kImgTX;
constexpr int kImgPts = kImgTile / kImgThreads;
static_assert(kImgTX % 32 == 0 && kImgThreads % 32 == 0 &&
                  kImgTile % kImgThreads == 0,
              "a tile's rows along x and its threads are whole warps");
static_assert(kImgSmemFloats % 4 == 0, "the box is zeroed as float4");

// an axis with a tap of nonzero weight, and its lowest and highest such tap
__device__ __forceinline__ bool axis_live(const Axis& a) {
  return a.w0 != 0.f || a.w1 != 0.f;
}

__device__ __forceinline__ int live_lo(const Axis& a) {
  return a.w0 != 0.f ? a.i0 : a.i1;
}

__device__ __forceinline__ int live_hi(const Axis& a) {
  return a.w1 != 0.f ? a.i1 : a.i0;
}

// dtaps[0..3] += v as one 16-byte reduction (red.global.add.v4.f32, sm_90)
__device__ __forceinline__ void red_add_v4(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

// The cotangents of a thread's points for channels g0 .. g0 + nch - 1 of
// g (B * C, M), doubled under rescale (d(out * 2 - 1)/d out, exact); 0 past
// nch and for masked points. All are loaded together, so that their
// latencies overlap.
__device__ __forceinline__ void load_cotangents(
    float (&gv)[kImgChan][kImgPts], const float* __restrict__ g, int64_t g0,
    int nch, int M, const int* m, int rescale) {
  const float gs = rescale ? 2.f : 1.f;
#pragma unroll
  for (int cl = 0; cl < kImgChan; ++cl)
#pragma unroll
    for (int p = 0; p < kImgPts; ++p)
      gv[cl][p] = cl < nch && m[p] >= 0
                      ? __ldg(g + (g0 + cl) * M + m[p]) * gs
                      : 0.f;
}

// Add each live term (g * w_z) * (w_y * w_x) of a thread's points, for
// nch <= kImgChan channels with the cotangents gv[cl], at base + cl *
// cstride + ((z - oz) * sy + y - oy) * sx + x - ox, with f32 atomics: into
// a tile's box in shared memory (origin (oz, oy, ox), strides (sy, sx)), or
// into dtaps (origin 0, strides (W, H)). A tap of weight 0 takes no term
// (a masked point's weights are 0).
__device__ __forceinline__ void add_terms(
    float* base, int64_t cstride, int nch,
    const float (&gv)[kImgChan][kImgPts], const Axis* az, const Axis* ay,
    const Axis* ax, int oz, int oy, int ox, int sy, int sx) {
#pragma unroll
  for (int p = 0; p < kImgPts; ++p) {
    int at[8];
    const int zy[2] = {(az[p].i0 - oz) * sy - oy, (az[p].i1 - oz) * sy - oy};
#pragma unroll
    for (int k = 0; k < 8; ++k)
      at[k] = (zy[k >> 2] + ((k >> 1) & 1 ? ay[p].i1 : ay[p].i0)) * sx +
              (k & 1 ? ax[p].i1 : ax[p].i0) - ox;
    const float wz[2] = {az[p].w0, az[p].w1};
    const float wyx[4] = {
        __fmul_rn(ay[p].w0, ax[p].w0), __fmul_rn(ay[p].w0, ax[p].w1),
        __fmul_rn(ay[p].w1, ax[p].w0), __fmul_rn(ay[p].w1, ax[p].w1)};
    int live = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (wz[k >> 2] != 0.f && wyx[k & 3] != 0.f) live |= 1 << k;
    if (!live) continue;
#pragma unroll
    for (int cl = 0; cl < kImgChan; ++cl) {
      if (cl >= nch) break;
      float* bc = base + cl * cstride;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if ((live >> k) & 1)
          atomicAdd(bc + at[k],
                    __fmul_rn(__fmul_rn(gv[cl][p], wz[k >> 2]), wyx[k & 3]));
    }
  }
}

template <int MODES, int LAYOUT>
__global__ void __launch_bounds__(kImgThreads, kImgMinBlocks)
warp_image_grad_kernel(const float* __restrict__ pts,
                       const float* __restrict__ g,
                       float* __restrict__ dtaps,
                       unsigned long long* __restrict__ overflow, int C,
                       int D, int W, int H, int M, int Do, int Wo, int Ho,
                       int border, int modes, int rescale, int vec) {
  extern __shared__ float4 box4[];
  float* box = reinterpret_cast<float*>(box4);
  // the box's corners: low z, y, x and minus the high ones, by atomicMin
  __shared__ int corner[6];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  if (tid < 6) corner[tid] = INT_MAX;
  const float scale[3] = {0.5f * static_cast<float>(D - 1),
                          0.5f * static_cast<float>(W - 1),
                          0.5f * static_cast<float>(H - 1)};

  // the tile's points: m = -1 past the end of the grid or of the points
  int m[kImgPts];
  int nvalid;
  if (Do > 0) {
    const int ntx = (Ho + kImgTX - 1) / kImgTX;
    const int nty = (Wo + kImgTY - 1) / kImgTY;
    int t = blockIdx.x;
    const int x0 = (t % ntx) * kImgTX;
    t /= ntx;
    const int y0 = (t % nty) * kImgTY;
    const int z0 = (t / nty) * kImgTZ;
#pragma unroll
    for (int p = 0; p < kImgPts; ++p) {
      const int q = p * kImgThreads + tid;
      const int x = x0 + q % kImgTX;
      const int y = y0 + (q / kImgTX) % kImgTY;
      const int z = z0 + q / (kImgTX * kImgTY);
      m[p] = x < Ho && y < Wo && z < Do ? (z * Wo + y) * Ho + x : -1;
    }
    nvalid = min(kImgTX, Ho - x0) * min(kImgTY, Wo - y0) *
             min(kImgTZ, Do - z0);
  } else {
    const int m0 = blockIdx.x * kImgTile;
#pragma unroll
    for (int p = 0; p < kImgPts; ++p) {
      const int q = m0 + p * kImgThreads + tid;
      m[p] = q < M ? q : -1;
    }
    nvalid = min(kImgTile, M - m0);
  }

  // the first channels' cotangents, in flight with the points' loads
  float gv[kImgChan][kImgPts];
  load_cotangents(gv, g, static_cast<int64_t>(b) * C, min(C, kImgChan), M,
                  m, rescale);
  // each point's taps and weights, and the box of the block's live taps
  // (a tap of weight 0 adds nothing, so points outside a zeros-padded
  // volume leave the box alone)
  Axis az[kImgPts], ay[kImgPts], ax[kImgPts];
  int ext[6] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX, INT_MAX, INT_MAX};
#pragma unroll
  for (int p = 0; p < kImgPts; ++p) {
    float c[3] = {0.f, 0.f, 0.f};
    if (m[p] >= 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float v =
            LAYOUT == kPixel
                ? __ldg(pts + 3 * (static_cast<int64_t>(b) * M + m[p]) + a)
                : __ldg(pts + (static_cast<int64_t>(b) * 3 + a) * M + m[p]);
        c[a] = LAYOUT == kPixel ? v : __fmul_rn(__fadd_rn(v, 1.f), scale[a]);
      }
    }
    az[p] = axis_taps(c[0], D, border, axis_mode<MODES>(modes, 0));
    ay[p] = axis_taps(c[1], W, border, axis_mode<MODES>(modes, 1));
    ax[p] = axis_taps(c[2], H, border, axis_mode<MODES>(modes, 2));
    // a masked point adds nothing
    if (m[p] < 0) az[p].w0 = az[p].w1 = 0.f;
    if (axis_live(az[p]) && axis_live(ay[p]) && axis_live(ax[p])) {
      ext[0] = min(ext[0], live_lo(az[p]));
      ext[1] = min(ext[1], live_lo(ay[p]));
      ext[2] = min(ext[2], live_lo(ax[p]));
      ext[3] = min(ext[3], -live_hi(az[p]));
      ext[4] = min(ext[4], -live_hi(ay[p]));
      ext[5] = min(ext[5], -live_hi(ax[p]));
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) ext[k] = __reduce_min_sync(0xffffffffu, ext[k]);
  __syncthreads();
  if ((tid & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) atomicMin(&corner[k], ext[k]);
  }
  __syncthreads();
  const int zlo = corner[0], ylo = corner[1], xlo = corner[2];
  const int zhi = -corner[3], yhi = -corner[4], xhi = -corner[5];
  // no live tap in the tile (every point outside a zeros-padded volume)
  if (zlo > zhi) return;
  // with vec the box's rows start and end on 16-byte boundaries of dtaps
  const int xs = vec ? xlo & ~3 : xlo;
  const int xe = vec ? min((xhi | 3) + 1, H) : xhi + 1;
  const int bx = xe - xs, by = yhi - ylo + 1, bz = zhi - zlo + 1;
  const int64_t box_n = static_cast<int64_t>(bz) * by * bx;
  const int per = box_n <= kImgSmemFloats ? static_cast<int>(box_n) : 0;
  // channels a pass; 0: the box overflows the budget
  const int cpass = per ? min(min(C, kImgChan), kImgSmemFloats / per) : 0;
  const int S = D * W * H;

  if (cpass == 0) {
    // the overflow path: the terms straight to dtaps, as f32 atomics
    if (overflow != nullptr && tid == 0)
      atomicAdd(overflow, static_cast<unsigned long long>(nvalid));
    for (int c0 = 0; c0 < C; c0 += kImgChan) {
      const int nc = min(kImgChan, C - c0);
      if (c0 > 0)
        load_cotangents(gv, g, static_cast<int64_t>(b) * C + c0, nc, M, m,
                        rescale);
      add_terms(dtaps + (static_cast<int64_t>(b) * C + c0) * S, S, nc, gv,
                az, ay, ax, 0, 0, 0, W, H);
    }
    return;
  }

  for (int c0 = 0; c0 < C; c0 += cpass) {
    const int nc = min(cpass, C - c0);
    if (c0 > 0)
      load_cotangents(gv, g, static_cast<int64_t>(b) * C + c0, nc, M, m,
                      rescale);
    const int n4 = (nc * per + 3) / 4;
    for (int i = tid; i < n4; i += kImgThreads)
      box4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    add_terms(box, per, nc, gv, az, ay, ax, zlo, ylo, xs, by, bx);
    __syncthreads();
    // the flush: a row of the box is bx consecutive taps of dtaps; taps
    // (vec: groups of 4) that stayed 0 are skipped
    if (vec) {
      const int q4 = bx >> 2;
      const int items = nc * bz * by * q4;
      for (int i = tid; i < items; i += kImgThreads) {
        const float4 v = box4[i];
        if (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f) continue;
        const int r = i / q4, j = i - r * q4;
        const int yy = r % by, t = r / by;
        const int zz = t % bz, cl = t / bz;
        red_add_v4(dtaps + (static_cast<int64_t>(b) * C + c0 + cl) * S +
                       ((zlo + zz) * W + ylo + yy) * H + xs + 4 * j,
                   v);
      }
    } else {
      const int items = nc * per;
      for (int i = tid; i < items; i += kImgThreads) {
        const float v = box[i];
        if (v == 0.f) continue;
        const int r = i / bx, xx = i - r * bx;
        const int yy = r % by, t = r / by;
        const int zz = t % bz, cl = t / bz;
        atomicAdd(dtaps + (static_cast<int64_t>(b) * C + c0 + cl) * S +
                      ((zlo + zz) * W + ylo + yy) * H + xs + xx,
                  v);
      }
    }
    if (c0 + cpass < C) __syncthreads();
  }
}

template <int MODES, int LAYOUT>
cudaError_t launch_image_grad(const float* pts, const float* g, float* dtaps,
                              unsigned long long* overflow, dim3 grid, int C,
                              int D, int W, int H, int M, int Do, int Wo,
                              int Ho, int border, int modes, int rescale,
                              int vec, cudaStream_t stream) {
  constexpr int kSmem = kImgSmemFloats * static_cast<int>(sizeof(float));
  // a budget above 48 KB (with the corners) must be asked for; the port's
  // 24 KB needs no call
  if constexpr (kSmem + 6 * sizeof(int) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        warp_image_grad_kernel<MODES, LAYOUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
  }
  warp_image_grad_kernel<MODES, LAYOUT><<<grid, kImgThreads, kSmem, stream>>>(
      pts, g, dtaps, overflow, C, D, W, H, M, Do, Wo, Ho, border, modes,
      rescale, vec);
  return cudaGetLastError();
}

template <int LAYOUT>
int image_grad(const float* pts, const float* g, float* dtaps,
               unsigned long long* overflow, int64_t B, int64_t C, int64_t D,
               int64_t W, int64_t H, int64_t M, int64_t Do, int64_t Wo,
               int64_t Ho, int border, int modes, int rescale, void* stream) {
  if (B * M == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles =
      Do > 0 ? ((Ho + kImgTX - 1) / kImgTX) * ((Wo + kImgTY - 1) / kImgTY) *
                   ((Do + kImgTZ - 1) / kImgTZ)
             : (M + kImgTile - 1) / kImgTile;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(B));
  // the flush's 16-byte reductions: rows of dtaps on 16-byte boundaries
  const int vec =
      H % 4 == 0 && reinterpret_cast<uintptr_t>(dtaps) % 16 == 0;
  const int c = static_cast<int>(C), d = static_cast<int>(D),
            w = static_cast<int>(W), h = static_cast<int>(H),
            m = static_cast<int>(M), dz = static_cast<int>(Do),
            wy = static_cast<int>(Wo), hx = static_cast<int>(Ho);
  cudaError_t e;
  if (modes == kAllOct)
    e = launch_image_grad<kAllOct, LAYOUT>(pts, g, dtaps, overflow, grid, c,
                                           d, w, h, m, dz, wy, hx, border,
                                           modes, rescale, vec, s);
  else if (modes == kQuadZ)
    e = launch_image_grad<kQuadZ, LAYOUT>(pts, g, dtaps, overflow, grid, c,
                                          d, w, h, m, dz, wy, hx, border,
                                          modes, rescale, vec, s);
  else
    e = launch_image_grad<-1, LAYOUT>(pts, g, dtaps, overflow, grid, c, d, w,
                                      h, m, dz, wy, hx, border, modes,
                                      rescale, vec, s);
  return static_cast<int>(e);
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
// weight at coords (B, M, 3). overflow (one 64-bit counter, or null)
// receives the points of each tile whose box overflowed the shared memory.
extern "C" int liftreg_warp_image_grad(const float* coords, const float* g,
                                       float* dtaps,
                                       unsigned long long* overflow,
                                       int64_t B, int64_t C, int64_t D,
                                       int64_t W, int64_t H, int64_t M,
                                       int border, int modes, void* stream) {
  return image_grad<kPixel>(coords, g, dtaps, overflow, B, C, D, W, H, M, 0,
                            0, 0, border, modes, 0, stream);
}

// the same for phi (B, 3, M), g doubled under rescale; (Do, Wo, Ho) is the
// out_shape of a 3-D phi (Do * Wo * Ho = M), tiled in 3-D, or Do = 0
extern "C" int liftreg_warp_image_grad_phi(const float* phi, const float* g,
                                           float* dtaps,
                                           unsigned long long* overflow,
                                           int64_t B, int64_t C, int64_t D,
                                           int64_t W, int64_t H, int64_t M,
                                           int64_t Do, int64_t Wo,
                                           int64_t Ho, int border, int modes,
                                           int rescale, void* stream) {
  return image_grad<kPhi>(phi, g, dtaps, overflow, B, C, D, W, H, M, Do, Wo,
                          Ho, border, modes, rescale, stream);
}
