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
// 5.5 GFLOP. Reducing every partial dot product across a warp as it is made
// costs more issue slots (shuffles) than the loads themselves, so the design
// makes one cross-lane reduction per block and basis row instead: each warp
// owns kGradRows consecutive basis rows, each lane owns 8 columns of every
// tile of 256 and keeps B x kGradRows f32 sums in registers over all of its
// block's tiles. A tile costs a lane one 16-byte load per row, all issued
// before the tile's cotangent is needed. The cotangent's B x 256 values of a
// tile are shared by every warp of the block: one cp.async.bulk copy per
// batch row (the TMA), issued by thread 0 two tiles ahead into a double
// buffer in shared memory and completed on an mbarrier; after one
// __syncthreads per tile thread 0 fences the async proxy and refills the
// buffer every warp has just read. (Reading the cotangent through L1 from
// every warp, staging the basis in shared memory too, and the tensor cores
// measured slower: tools/pca_variants/, tools/torch_grad_sweep.py.) At the
// end each warp reduces its sums across its lanes once and writes them to a
// (blocks, L, B) partial buffer; a second kernel, one warp per output, adds
// the blocks in a fixed order and rounds to bf16. No float atomics: the
// result does not depend on timing. A grid row (blockIdx.y) covers
// kGradMaxWarps * kGradRows basis rows, so any L is one launch. Without
// 16-byte loads (vec = 0) every lane reads its columns one at a time.
constexpr int kGradRows = 8;  // basis rows per warp
constexpr int kGradMaxWarps = 8;
constexpr int kGradTile = 32 * kCols;  // columns per tile: 8 per lane

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// arrive on the barrier and expect `bytes` of copies in its current phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// global -> shared copy of `bytes` (a multiple of 16) by the TMA
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void unpack8(const uint4& raw, float v[kCols]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < kCols / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

template <int B>
__global__ void __launch_bounds__(kGradMaxWarps * 32)
pca_grad_partial_kernel(const float* __restrict__ g,
                        const __nv_bfloat16* __restrict__ V,
                        float* __restrict__ partial, int64_t L, int64_t n,
                        int vec) {
  __shared__ alignas(128) float gs[2][B][kGradTile];
  __shared__ alignas(8) uint64_t bar[2];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row0 =
      (static_cast<int64_t>(blockIdx.y) * (blockDim.x / 32) + warp) *
      kGradRows;
  // a warp past the last row of a ragged L still takes part in the barriers
  const int rows = row0 >= L ? 0
                   : static_cast<int>(L - row0 < kGradRows ? L - row0
                                                           : kGradRows);
  const __nv_bfloat16* Vw = V + (rows ? row0 : 0) * n;

  float acc[B][kGradRows];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int r = 0; r < kGradRows; ++r) acc[b][r] = 0.f;

  // this block's tiles: blockIdx.x + k * gridDim.x for k < mine
  const int64_t tiles = (n + kGradTile - 1) / kGradTile;
  const int64_t mine =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  if (vec) {
    // tile k's cotangent into buffer k & 1 (n % 8 == 0 keeps every copy,
    // a ragged last tile's too, a multiple of 16 bytes)
    auto issue = [&](int64_t k) {
      const int64_t base = (blockIdx.x + k * gridDim.x) * kGradTile;
      const int64_t cols = n - base < kGradTile ? n - base : kGradTile;
      const uint32_t bytes = static_cast<uint32_t>(cols * sizeof(float));
      uint64_t* bk = &bar[k & 1];
      mbar_expect_tx(bk, bytes * B);
#pragma unroll
      for (int b = 0; b < B; ++b)
        bulk_copy(&gs[k & 1][b][0], g + b * n + base, bytes, bk);
    };
    if (threadIdx.x == 0) {
      mbar_init(&bar[0], 1);
      mbar_init(&bar[1], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      if (mine > 0) issue(0);
      if (mine > 1) issue(1);
    }
    for (int64_t k = 0; k < mine; ++k) {
      const int64_t j0 = (blockIdx.x + k * gridDim.x) * kGradTile + lane * kCols;
      const bool in = j0 < n;  // a lane's 8 columns are all in or all out
      uint4 raw[kGradRows];
#pragma unroll
      for (int r = 0; r < kGradRows; ++r)
        raw[r] = (r < rows && in)
                     ? __ldg(reinterpret_cast<const uint4*>(Vw + r * n + j0))
                     : make_uint4(0u, 0u, 0u, 0u);
      mbar_wait(&bar[k & 1], static_cast<uint32_t>((k >> 1) & 1));
      float gv[B][kCols];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float4 a =
            *reinterpret_cast<const float4*>(&gs[k & 1][b][lane * kCols]);
        const float4 c =
            *reinterpret_cast<const float4*>(&gs[k & 1][b][lane * kCols + 4]);
        gv[b][0] = a.x; gv[b][1] = a.y; gv[b][2] = a.z; gv[b][3] = a.w;
        gv[b][4] = c.x; gv[b][5] = c.y; gv[b][6] = c.z; gv[b][7] = c.w;
      }
      __syncthreads();  // every warp has read buffer k & 1
      if (threadIdx.x == 0 && k + 2 < mine) {
        // order those generic-proxy reads before the TMA's writes
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        issue(k + 2);
      }
      if (in) {
#pragma unroll
        for (int r = 0; r < kGradRows; ++r) {
          float v[kCols];
          unpack8(raw[r], v);
#pragma unroll
          for (int b = 0; b < B; ++b)
#pragma unroll
            for (int q = 0; q < kCols; ++q)
              acc[b][r] = fmaf(gv[b][q], v[q], acc[b][r]);
        }
      }
    }
  } else {
    for (int64_t k = 0; k < mine; ++k) {
      const int64_t j0 =
          (blockIdx.x + k * gridDim.x) * kGradTile + lane * kCols;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        if (j0 + q >= n) continue;
        float gk[B];
#pragma unroll
        for (int b = 0; b < B; ++b) gk[b] = g[b * n + j0 + q];
#pragma unroll
        for (int r = 0; r < kGradRows; ++r) {
          if (r >= rows) continue;
          const float v = __bfloat162float(Vw[r * n + j0 + q]);
#pragma unroll
          for (int b = 0; b < B; ++b) acc[b][r] = fmaf(gk[b], v, acc[b][r]);
        }
      }
    }
  }

  // one reduction across the warp's lanes per (row, batch row)
#pragma unroll
  for (int r = 0; r < kGradRows; ++r) {
    if (r >= rows) continue;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float p = acc[b][r];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        p += __shfl_down_sync(0xffffffffu, p, off);
      if (lane == 0)
        partial[(static_cast<int64_t>(blockIdx.x) * L + row0 + r) * B + b] = p;
    }
  }
}

// dcoefs[b, l] = bf16(sum over blocks of partial[blk, l, b]): one warp per
// output, each lane a fixed subset of the blocks, then a fixed shuffle tree
__global__ void pca_grad_finish_kernel(const float* __restrict__ partial,
                                       float* __restrict__ dcoefs, int64_t B,
                                       int64_t L, int64_t blocks) {
  const int64_t o =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (o >= B * L) return;
  const int64_t b = o / L;
  const int64_t l = o - b * L;
  float t = 0.f;
  for (int64_t k = lane; k < blocks; k += 32) t += partial[(k * L + l) * B + b];
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    t += __shfl_down_sync(0xffffffffu, t, off);
  if (lane == 0) dcoefs[o] = __bfloat162float(__float2bfloat16_rn(t));
}

template <int B>
cudaError_t launch_grad(const float* g, const void* V, float* partial,
                        float* dcoefs, int64_t L, int64_t n, int vec,
                        int64_t blocks, cudaStream_t stream) {
  // as many warps as the rows need, up to kGradMaxWarps; more rows take
  // more grid rows
  const int64_t warps_needed = (L + kGradRows - 1) / kGradRows;
  const int warps = static_cast<int>(
      warps_needed < kGradMaxWarps ? warps_needed : kGradMaxWarps);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>((warps_needed + warps - 1) / warps));
  pca_grad_partial_kernel<B><<<grid, warps * 32, 0, stream>>>(
      g, static_cast<const __nv_bfloat16*>(V), partial, L, n, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t threads = B * L * 32;
  pca_grad_finish_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256,
                           0, stream>>>(partial, dcoefs, B, L, blocks);
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
// B in [1, 8] (the wrapper checks); any L up to 65535 grid rows of 64.
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
