// PCA expansion on Hopper: out (B, n) = bf16(coefs) (B, L) @ V (L, n) + mean (n).
//
// Replaces liftreg_tpu/ops/pallas_pca.py:_expand_kernel (its pallas_call in
// expand_pca_streamed). Same arithmetic: the coefficients are rounded to bf16
// once (as pallas_pca.py casts them before the dot), the bf16 basis is widened
// to f32, products accumulate in f32, and the f32 mean is added last.
//
// Bound: bytes. At the serving shape (B=4, L=56, n=3*160^3) the one read of V
// is 1.376 GB, the mean 49 MB and the output 197 MB: 1.62 GB, ~0.48 ms at
// 3.35 TB/s, against 5.5 GFLOP of multiply-adds. The design reads every
// element of V exactly once for all B rows: each thread owns 8 consecutive
// columns, loads them from each basis row with one 16-byte load (neighbouring
// threads on neighbouring addresses), and keeps B x 8 f32 accumulators in
// registers. The B*L rounded coefficients sit in shared memory. Columns past n
// are masked; when n or a pointer does not allow 16-byte loads the wrapper
// passes vec=0 and every thread takes the scalar path.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 8;  // columns per thread: one 16-byte load of bf16
constexpr int kThreads = 256;

template <int B>
__global__ void __launch_bounds__(kThreads)
pca_expand_kernel(const float* __restrict__ coefs,
                  const __nv_bfloat16* __restrict__ V,
                  const float* __restrict__ mean, float* __restrict__ out,
                  int64_t L, int64_t n, int vec) {
  extern __shared__ float c_s[];  // (B, L) bf16-rounded coefficients
  for (int64_t i = threadIdx.x; i < B * L; i += blockDim.x)
    c_s[i] = __bfloat162float(__float2bfloat16_rn(coefs[i]));
  __syncthreads();

  const int64_t j0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kCols;
  if (j0 >= n) return;

  float acc[B][kCols];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[b][k] = 0.f;

  if (vec && j0 + kCols <= n) {
#pragma unroll 4
    for (int64_t l = 0; l < L; ++l) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(V + l * n + j0));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float v[kCols];
#pragma unroll
      for (int k = 0; k < kCols / 2; ++k) {
        const float2 f = __bfloat1622float2(h[k]);
        v[2 * k] = f.x;
        v[2 * k + 1] = f.y;
      }
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float c = c_s[b * L + l];
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[b][k] = fmaf(c, v[k], acc[b][k]);
      }
    }
    const float4 m0 = __ldg(reinterpret_cast<const float4*>(mean + j0));
    const float4 m1 = __ldg(reinterpret_cast<const float4*>(mean + j0 + 4));
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float4* o = reinterpret_cast<float4*>(out + b * n + j0);
      o[0] = make_float4(acc[b][0] + m0.x, acc[b][1] + m0.y,
                         acc[b][2] + m0.z, acc[b][3] + m0.w);
      o[1] = make_float4(acc[b][4] + m1.x, acc[b][5] + m1.y,
                         acc[b][6] + m1.z, acc[b][7] + m1.w);
    }
    return;
  }

  // scalar path: the ragged tail, or a length/pointer without 16-byte loads
  for (int64_t l = 0; l < L; ++l) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      if (j0 + k < n) {
        const float v = __bfloat162float(V[l * n + j0 + k]);
#pragma unroll
        for (int b = 0; b < B; ++b)
          acc[b][k] = fmaf(c_s[b * L + l], v, acc[b][k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (j0 + k < n) {
      const float m = mean[j0 + k];
#pragma unroll
      for (int b = 0; b < B; ++b) out[b * n + j0 + k] = acc[b][k] + m;
    }
  }
}

template <int B>
cudaError_t launch(const float* coefs, const void* V, const float* mean,
                   float* out, int64_t L, int64_t n, int vec,
                   cudaStream_t stream) {
  const int64_t threads = (n + kCols - 1) / kCols;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const size_t smem = sizeof(float) * B * L;
  pca_expand_kernel<B><<<blocks, kThreads, smem, stream>>>(
      coefs, static_cast<const __nv_bfloat16*>(V), mean, out, L, n, vec);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// B must lie in [1, 8] and B*L*4 bytes within 48 KB (the wrapper checks).
extern "C" int liftreg_pca_expand(const float* coefs, const void* vectors,
                                  const float* mean, float* out, int64_t B,
                                  int64_t L, int64_t n, int vec,
                                  void* stream) {
  if (n <= 0 || L <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 1: return launch<1>(coefs, vectors, mean, out, L, n, vec, s);
    case 2: return launch<2>(coefs, vectors, mean, out, L, n, vec, s);
    case 3: return launch<3>(coefs, vectors, mean, out, L, n, vec, s);
    case 4: return launch<4>(coefs, vectors, mean, out, L, n, vec, s);
    case 5: return launch<5>(coefs, vectors, mean, out, L, n, vec, s);
    case 6: return launch<6>(coefs, vectors, mean, out, L, n, vec, s);
    case 7: return launch<7>(coefs, vectors, mean, out, L, n, vec, s);
    case 8: return launch<8>(coefs, vectors, mean, out, L, n, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Name of a CUDA error code, for the Python wrappers' messages.
extern "C" const char* liftreg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
