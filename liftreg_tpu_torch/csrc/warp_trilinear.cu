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
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_tap(const float* p, int64_t i) {
  return __ldg(p + i);
}

__device__ __forceinline__ float load_tap(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

// start and the two relu-hat weights along one axis of n >= 2 voxels
__device__ __forceinline__ void axis_weights(float c, int64_t n, int border,
                                             int64_t* start, float* w0,
                                             float* w1) {
  if (border) c = fminf(fmaxf(c, 0.f), static_cast<float>(n - 1));
  const float s = fminf(fmaxf(floorf(c), 0.f), static_cast<float>(n - 2));
  const float t = c - s;
  *start = static_cast<int64_t>(s);
  *w0 = fmaxf(0.f, 1.f - fabsf(t));
  *w1 = fmaxf(0.f, 1.f - fabsf(t - 1.f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_trilinear_kernel(const T* __restrict__ taps,
                      const float* __restrict__ coords,
                      float* __restrict__ out, int64_t B, int64_t C,
                      int64_t D, int64_t W, int64_t H, int64_t M,
                      int border) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B * M) return;
  const int64_t b = i / M;
  const int64_t m = i - b * M;

  int64_t sz, sy, sx;
  float wz[2], wy[2], wx[2];
  axis_weights(__ldg(coords + 3 * i + 0), D, border, &sz, &wz[0], &wz[1]);
  axis_weights(__ldg(coords + 3 * i + 1), W, border, &sy, &wy[0], &wy[1]);
  axis_weights(__ldg(coords + 3 * i + 2), H, border, &sx, &wx[0], &wx[1]);

  const int64_t S = D * W * H;
  const int64_t base = (sz * W + sy) * H + sx;
  for (int64_t ch = 0; ch < C; ++ch) {
    const T* v = taps + (b * C + ch) * S + base;
    float acc = 0.f;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float w = __fmul_rn(__fmul_rn(wz[dz], wy[dy]), wx[dx]);
          const float tap = load_tap(v, (dz * W + dy) * H + dx);
          acc = __fadd_rn(acc, __fmul_rn(tap, w));
        }
    out[(b * C + ch) * M + m] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* taps, const float* coords, float* out,
                   int64_t B, int64_t C, int64_t D, int64_t W, int64_t H,
                   int64_t M, int border, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((B * M + kThreads - 1) / kThreads);
  warp_trilinear_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(taps), coords, out, B, C, D, W, H, M, border);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// taps_bf16 selects bf16 taps (else f32); border selects border padding
// (else zeros). D, W and H must be >= 2 (the wrapper checks).
extern "C" int liftreg_warp_trilinear(const void* taps, int taps_bf16,
                                      const float* coords, float* out,
                                      int64_t B, int64_t C, int64_t D,
                                      int64_t W, int64_t H, int64_t M,
                                      int border, void* stream) {
  if (B * M == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps_bf16)
    return launch<__nv_bfloat16>(taps, coords, out, B, C, D, W, H, M, border,
                                 s);
  return launch<float>(taps, coords, out, B, C, D, W, H, M, border, s);
}
