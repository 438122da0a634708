// Backprojection lift on Hopper: out (B, P, D, W, H) with
//   out[b,p,:,k,:] = Bu[p,k] @ proj[b,p] @ Bv[p,k]^T,
// computed from the per-plane pixel coordinates instead of the dense
// interpolation matrices: row d of Bu[p,k] holds the two taps of
// u_pix[p,k,d], row h of Bv[p,k] those of v_pix[p,k,h]. The reversed coronal
// axis (y_world = W-1-k) is already folded into the coordinates, as it is
// into Bu/Bv (liftreg_tpu/ops/drr.py:backward_matrices).
//
// Replaces liftreg_tpu/ops/pallas_drr.py:_backproj_kernel (its pallas_call
// in backproject_with_mats_pallas), which runs two dense MXU matmuls per
// coronal plane. Weights as in drr_project.cu: max(0, 1 - |pix - m|) for the
// two taps m = floor(pix), floor(pix)+1, each dropped outside [0, n-1].
//
// Bound: bytes. At the serving shape (B=4, P=4, 240^2 detector, 160^3) the
// f32 output is 262 MB, ~0.08 ms at 3.35 TB/s; the inputs are under 4 MB and
// each output needs 4 taps (~12 f32 operations, ~0.01 ms at 67 TFLOP/s).
// One thread writes one output voxel, h fastest, so a warp writes 128
// contiguous bytes and reads one or two detector rows at neighbouring
// positions; the 0.9 MB detector image of a view stays in L1/L2.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float tap_weight(float pix, int64_t m) {
  return fmaxf(0.f, 1.f - fabsf(pix - static_cast<float>(m)));
}

__global__ void __launch_bounds__(kThreads)
drr_backproject_kernel(const float* __restrict__ proj,
                       const float* __restrict__ u_pix,
                       const float* __restrict__ v_pix,
                       float* __restrict__ out, int64_t total, int64_t P,
                       int64_t D, int64_t W, int64_t H, int64_t PW,
                       int64_t PH) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  int64_t r = idx;
  const int64_t h = r % H;
  r /= H;
  const int64_t k = r % W;
  r /= W;
  const int64_t d = r % D;
  const int64_t bp = r / D;
  const int64_t p = bp % P;

  const float up = __ldg(u_pix + (p * W + k) * D + d);
  const float vp = __ldg(v_pix + (p * W + k) * H + h);
  const int64_t mu0 = static_cast<int64_t>(floorf(up));
  const int64_t mv0 = static_cast<int64_t>(floorf(vp));
  const float* img = proj + bp * PW * PH;
  float acc = 0.f;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int64_t mu = mu0 + a;
    if (mu < 0 || mu >= PW) continue;
    const float* row = img + mu * PH;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int64_t mv = mv0 + c;
      if (mv < 0 || mv >= PH) continue;
      s = fmaf(tap_weight(vp, mv), __ldg(row + mv), s);
    }
    acc = fmaf(tap_weight(up, mu), s, acc);
  }
  out[idx] = acc;
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// proj (B, P, PW, PH), u_pix (P, W, D), v_pix (P, W, H), out (B, P, D, W, H);
// all f32 and contiguous (the wrapper checks).
extern "C" int liftreg_drr_backproject(const float* proj, const float* u_pix,
                                       const float* v_pix, float* out,
                                       int64_t B, int64_t P, int64_t D,
                                       int64_t W, int64_t H, int64_t PW,
                                       int64_t PH, void* stream) {
  const int64_t total = B * P * D * W * H;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  drr_backproject_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      proj, u_pix, v_pix, out, total, P, D, W, H, PW, PH);
  return static_cast<int>(cudaGetLastError());
}
