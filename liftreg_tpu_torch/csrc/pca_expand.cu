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


// ---------------------------------------------------------------------------
// PCA backward: dcoefs (B, L) = bf16(g (B, n) @ V (L, n)^T), f32 products and
// sums. It is what JAX's autodiff of models/subspace_backproj.expand_pca
// computes for a bf16 basis (dot_general of the f32 cotangent and the bf16
// basis with f32 accumulation, then the cast back through the bf16
// coefficients); the JAX package leaves it to XLA (and its Pallas route,
// pallas_pca._expand_bwd, rounds g instead).
//
// Bound: bytes. The basis is read once (1.376 GB at the serving shape) with
// the f32 cotangent (197 MB): ~0.47 ms at 3.35 TB/s against 2*B*L*n =
// 5.5 GFLOP. Each thread owns 8 columns per tile: it loads its B x 8
// cotangent values once per tile, then for every basis row one 16-byte load,
// and reduces the B partial dot products across its warp with shuffles; lane
// 0 adds them to its warp's (L, B) slot in shared memory. A block walks over
// tiles grid-stride and writes its warps' sums, in warp order, to a
// (blocks, L, B) partial buffer; a second kernel sums the blocks in order and
// rounds to bf16. No float atomics: the result does not depend on timing.
template <int B>
__global__ void __launch_bounds__(kThreads)
pca_grad_partial_kernel(const float* __restrict__ g,
                        const __nv_bfloat16* __restrict__ V,
                        float* __restrict__ partial, int64_t L, int64_t n,
                        int vec) {
  extern __shared__ float s[];  // (warps, L, B)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  float* mine = s + static_cast<int64_t>(warp) * L * B;
  for (int64_t i = lane; i < L * B; i += 32) mine[i] = 0.f;
  __syncwarp();

  const int64_t tile_cols = static_cast<int64_t>(blockDim.x) * kCols;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * tile_cols; base < n;
       base += static_cast<int64_t>(gridDim.x) * tile_cols) {
    const int64_t j0 = base + static_cast<int64_t>(threadIdx.x) * kCols;
    const bool full = vec && j0 + kCols <= n;
    float gv[B][kCols];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (full) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(g + b * n + j0));
        const float4 c =
            __ldg(reinterpret_cast<const float4*>(g + b * n + j0 + 4));
        gv[b][0] = a.x; gv[b][1] = a.y; gv[b][2] = a.z; gv[b][3] = a.w;
        gv[b][4] = c.x; gv[b][5] = c.y; gv[b][6] = c.z; gv[b][7] = c.w;
      } else {
#pragma unroll
        for (int k = 0; k < kCols; ++k)
          gv[b][k] = j0 + k < n ? g[b * n + j0 + k] : 0.f;
      }
    }
    for (int64_t l = 0; l < L; ++l) {
      float v[kCols];
      if (full) {
        const uint4 raw =
            __ldg(reinterpret_cast<const uint4*>(V + l * n + j0));
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int k = 0; k < kCols / 2; ++k) {
          const float2 f = __bfloat1622float2(h[k]);
          v[2 * k] = f.x;
          v[2 * k + 1] = f.y;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kCols; ++k)
          v[k] = j0 + k < n ? __bfloat162float(V[l * n + j0 + k]) : 0.f;
      }
#pragma unroll
      for (int b = 0; b < B; ++b) {
        float p = 0.f;
#pragma unroll
        for (int k = 0; k < kCols; ++k) p = fmaf(gv[b][k], v[k], p);
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          p += __shfl_down_sync(0xffffffffu, p, off);
        if (lane == 0) mine[l * B + b] += p;
      }
    }
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < L * B; i += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < warps; ++w) t += s[static_cast<int64_t>(w) * L * B + i];
    partial[static_cast<int64_t>(blockIdx.x) * L * B + i] = t;
  }
}

// dcoefs[b, l] = bf16(sum over blocks of partial[blk, l, b]), blocks in order
__global__ void pca_grad_finish_kernel(const float* __restrict__ partial,
                                       float* __restrict__ dcoefs, int64_t B,
                                       int64_t L, int64_t blocks) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B * L) return;
  const int64_t b = i / L;
  const int64_t l = i - b * L;
  float t = 0.f;
  for (int64_t k = 0; k < blocks; ++k) t += partial[(k * L + l) * B + b];
  dcoefs[i] = __bfloat162float(__float2bfloat16_rn(t));
}

template <int B>
cudaError_t launch_grad(const float* g, const void* V, float* partial,
                        float* dcoefs, int64_t L, int64_t n, int vec,
                        int64_t blocks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kThreads / 32) * L * B;
  pca_grad_partial_kernel<B><<<static_cast<unsigned>(blocks), kThreads, smem,
                               stream>>>(
      g, static_cast<const __nv_bfloat16*>(V), partial, L, n, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t outs = B * L;
  pca_grad_finish_kernel<<<static_cast<unsigned>((outs + 255) / 256), 256, 0,
                           stream>>>(partial, dcoefs, B, L, blocks);
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

// Launches the PCA backward's two kernels on `stream` without synchronising;
// returns cudaGetLastError(). partial is scratch of blocks*L*B floats;
// B in [1, 8] and 8*L*B*4 bytes of shared memory within 48 KB (the wrapper
// checks).
extern "C" int liftreg_pca_grad(const float* g, const void* vectors,
                                float* partial, float* dcoefs, int64_t B,
                                int64_t L, int64_t n, int vec, int64_t blocks,
                                void* stream) {
  if (L <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 1: return launch_grad<1>(g, vectors, partial, dcoefs, L, n, vec, blocks, s);
    case 2: return launch_grad<2>(g, vectors, partial, dcoefs, L, n, vec, blocks, s);
    case 3: return launch_grad<3>(g, vectors, partial, dcoefs, L, n, vec, blocks, s);
    case 4: return launch_grad<4>(g, vectors, partial, dcoefs, L, n, vec, blocks, s);
    case 5: return launch_grad<5>(g, vectors, partial, dcoefs, L, n, vec, blocks, s);
    case 6: return launch_grad<6>(g, vectors, partial, dcoefs, L, n, vec, blocks, s);
    case 7: return launch_grad<7>(g, vectors, partial, dcoefs, L, n, vec, blocks, s);
    case 8: return launch_grad<8>(g, vectors, partial, dcoefs, L, n, vec, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Name of a CUDA error code, for the Python wrappers' messages.
extern "C" const char* liftreg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
