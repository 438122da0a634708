// DRR projector on Hopper: out (B, P, RD, RH) = 0.1 * dx[p] *
//   sum_k Rx[p,k] @ vol[b, :, k, :] @ Rz[p,k]^T,
// computed from the per-plane pixel coordinates instead of the dense
// interpolation matrices: row i of Rx[p,k] holds the two taps of
// x_pix[p,k,i], row j of Rz[p,k] those of z_pix[p,k,j].
//
// Replaces liftreg_tpu/ops/pallas_drr.py:_proj_kernel (its pallas_call in
// project_with_mats_pallas), which runs the same function as a dense MXU
// matmul chain per coronal plane. The weights are those of
// liftreg_tpu/ops/drr.py:_two_tap_matrix: max(0, 1 - |pix - m|) for
// m = floor(pix) and floor(pix) + 1, each tap dropped when m lies outside
// [0, n-1] (per-tap zero padding; no clamping of the start, unlike the warp).
//
// Bound: operations. At the serving shape (B=4, P=4, 160^3, 240^2) the volume
// is 66 MB and the output 3.7 MB (~0.02 ms at 3.35 TB/s), while every
// (pixel, plane) pair needs 4 taps with a weight product, a product and a
// sum: 12 f32 operations x 147M pairs, ~0.03 ms at 67 TFLOP/s. One thread
// computes one detector pixel and loops over the W planes; the threads of a
// block share the detector row i, so per plane they read one volume row
// (x tap) at neighbouring z positions, and the block's x coordinate is one
// broadcast load. The volume of one batch element (16 MB) stays in L2 while
// the blocks of its P views run.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float tap_weight(float pix, int64_t m) {
  return fmaxf(0.f, 1.f - fabsf(pix - static_cast<float>(m)));
}

__global__ void __launch_bounds__(kThreads)
drr_project_kernel(const float* __restrict__ vol,
                   const float* __restrict__ x_pix,
                   const float* __restrict__ z_pix,
                   const float* __restrict__ dx, float* __restrict__ out,
                   int64_t P, int64_t D, int64_t W, int64_t H, int64_t RD,
                   int64_t RH) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= RH) return;
  const int64_t i = blockIdx.y;
  const int64_t bp = blockIdx.z;
  const int64_t b = bp / P;
  const int64_t p = bp - b * P;
  const float* v = vol + b * D * W * H;

  float acc = 0.f;
  for (int64_t k = 0; k < W; ++k) {
    const float xp = __ldg(x_pix + (p * W + k) * RD + i);
    const float zp = __ldg(z_pix + (p * W + k) * RH + j);
    const int64_t mx0 = static_cast<int64_t>(floorf(xp));
    const int64_t mz0 = static_cast<int64_t>(floorf(zp));
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int64_t mx = mx0 + a;
      if (mx < 0 || mx >= D) continue;
      const float wx = tap_weight(xp, mx);
      const float* row = v + (mx * W + k) * H;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int64_t mz = mz0 + c;
        if (mz < 0 || mz >= H) continue;
        s = fmaf(tap_weight(zp, mz), __ldg(row + mz), s);
      }
      acc = fmaf(wx, s, acc);
    }
  }
  const int64_t o = (p * RD + i) * RH + j;
  out[(bp * RD + i) * RH + j] = acc * __ldg(dx + o) * 0.1f;
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// vol (B, D, W, H), x_pix (P, W, RD), z_pix (P, W, RH), dx (P, RD, RH),
// out (B, P, RD, RH); all f32 and contiguous (the wrapper checks).
extern "C" int liftreg_drr_project(const float* vol, const float* x_pix,
                                   const float* z_pix, const float* dx,
                                   float* out, int64_t B, int64_t P,
                                   int64_t D, int64_t W, int64_t H,
                                   int64_t RD, int64_t RH, void* stream) {
  if (B * P * RD * RH == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((RH + kThreads - 1) / kThreads),
                  static_cast<unsigned>(RD), static_cast<unsigned>(B * P));
  drr_project_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      vol, x_pix, z_pix, dx, out, P, D, W, H, RD, RH);
  return static_cast<int>(cudaGetLastError());
}
