// Variant of the PCA backward in liftreg_tpu_torch/csrc/pca_expand.cu for
// tools/torch_grad_sweep.py: the cotangent's tile is staged in shared memory
// by the Tensor Memory Accelerator. Same entry point (liftreg_pca_grad),
// same arithmetic in the same order, so the same bits.
//
// As in csrc/, each warp owns kGradRows basis rows and each lane 8 columns
// of a 256-column tile, with B x kGradRows f32 sums in registers. Here the
// block's B x 256 cotangent values of a tile arrive in shared memory through
// one cp.async.bulk copy per batch row, issued by thread 0 two tiles ahead
// into a double buffer and completed on an mbarrier, instead of every warp
// reading them through L1. A tile then costs a lane its kGradRows basis
// loads (issued before the wait, or a tile ahead with
// LIFTREG_PCA_GRAD_PREFETCH=1), a wait on the tile's barrier, B x 2 shared
// 16-byte reads and one __syncthreads, after which thread 0 fences the
// async proxy and refills the buffer it just freed. A ragged last tile
// copies only its columns (n % 8 == 0 keeps every copy a multiple of 16
// bytes). Without 16-byte alignment (vec = 0) the block takes the scalar
// path of csrc/ through __ldg.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 8;
#ifndef LIFTREG_PCA_GRAD_ROWS
#define LIFTREG_PCA_GRAD_ROWS 8
#endif
#ifndef LIFTREG_PCA_GRAD_PREFETCH
#define LIFTREG_PCA_GRAD_PREFETCH 0
#endif
constexpr int kGradRows = LIFTREG_PCA_GRAD_ROWS;
// 1: a lane loads the next tile's basis rows before it uses the current
// tile's
constexpr bool kGradPrefetch = LIFTREG_PCA_GRAD_PREFETCH != 0;
constexpr int kGradMaxWarps = 8;
constexpr int kGradTile = 32 * kCols;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

#ifndef LIFTREG_PCA_GRAD_LDNA
#define LIFTREG_PCA_GRAD_LDNA 0
#endif
// 16 bytes of the basis: through the read-only cache, or (LDNA = 1) without
// allocating in L1 and with a 256-byte L2 prefetch
__device__ __forceinline__ uint4 load_basis(const __nv_bfloat16* p) {
#if LIFTREG_PCA_GRAD_LDNA
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
#else
  return __ldg(reinterpret_cast<const uint4*>(p));
#endif
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

  const int64_t tiles = (n + kGradTile - 1) / kGradTile;
  const int64_t mine =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  if (vec) {
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
    auto load_rows = [&](uint4 (&raw)[kGradRows], int64_t k) {
      const int64_t j0 =
          (blockIdx.x + k * gridDim.x) * kGradTile + lane * kCols;
      const bool in = k < mine && j0 < n;
#pragma unroll
      for (int r = 0; r < kGradRows; ++r)
        raw[r] = (r < rows && in) ? load_basis(Vw + r * n + j0)
                                  : make_uint4(0u, 0u, 0u, 0u);
    };
    uint4 next[kGradRows];
    if (kGradPrefetch) load_rows(next, 0);
    for (int64_t k = 0; k < mine; ++k) {
      const int64_t base = (blockIdx.x + k * gridDim.x) * kGradTile;
      const int64_t j0 = base + lane * kCols;
      const bool in = j0 < n;
      uint4 raw[kGradRows];
      if (kGradPrefetch) {
#pragma unroll
        for (int r = 0; r < kGradRows; ++r) raw[r] = next[r];
        load_rows(next, k + 1);
      } else {
        load_rows(raw, k);
      }
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
      const int64_t j0 = (blockIdx.x + k * gridDim.x) * kGradTile + lane * kCols;
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

// the same with one warp per output: each lane a fixed subset of the
// blocks, then a fixed shuffle tree
__global__ void pca_grad_finish_warp_kernel(const float* __restrict__ partial,
                                            float* __restrict__ dcoefs,
                                            int64_t B, int64_t L,
                                            int64_t blocks) {
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

#ifndef LIFTREG_PCA_GRAD_WARP_FINISH
#define LIFTREG_PCA_GRAD_WARP_FINISH 0
#endif

template <int B>
cudaError_t launch_grad(const float* g, const void* V, float* partial,
                        float* dcoefs, int64_t L, int64_t n, int vec,
                        int64_t blocks, cudaStream_t stream) {
  const int64_t warps_needed = (L + kGradRows - 1) / kGradRows;
  const int warps = static_cast<int>(
      warps_needed < kGradMaxWarps ? warps_needed : kGradMaxWarps);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>((warps_needed + warps - 1) / warps));
  pca_grad_partial_kernel<B><<<grid, warps * 32, 0, stream>>>(
      g, static_cast<const __nv_bfloat16*>(V), partial, L, n, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (LIFTREG_PCA_GRAD_WARP_FINISH) {
    const int64_t threads = B * L * 32;
    pca_grad_finish_warp_kernel<<<static_cast<unsigned>((threads + 255) / 256),
                                  256, 0, stream>>>(partial, dcoefs, B, L,
                                                    blocks);
  } else {
    const int64_t outs = B * L;
    pca_grad_finish_kernel<<<static_cast<unsigned>((outs + 255) / 256), 256,
                             0, stream>>>(partial, dcoefs, B, L, blocks);
  }
  return cudaGetLastError();
}

}  // namespace

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

extern "C" const char* liftreg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
