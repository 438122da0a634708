// Variant of the PCA backward in liftreg_tpu_torch/csrc/pca_expand.cu for
// tools/torch_grad_sweep.py: the basis and the cotangent both arrive in
// shared memory through the TMA, kStages tiles ahead.
//
// As in csrc/, each warp owns 8 basis rows and each lane 8 columns of a
// 256-column tile, with B x 8 f32 sums in registers, and the arithmetic is
// the same in the same order. Here the block's rows of a tile (512 bytes
// each) and its B cotangent rows (1 KB each) are bulk-copied into a ring of
// kStages buffers, completed on one mbarrier per buffer; lanes of warp 0
// issue the copies of tile k + kStages as soon as every warp has finished
// tile k (one __syncthreads per tile). The loads in flight then cost no
// registers, so they do not stop while a warp computes. Without 16-byte
// alignment (vec = 0) the block takes the scalar path of csrc/.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 8;
constexpr int kGradRows = 8;
constexpr int kGradMaxWarps = 8;
constexpr int kGradTile = 32 * kCols;
#ifndef LIFTREG_PCA_GRAD_STAGES
#define LIFTREG_PCA_GRAD_STAGES 3
#endif
constexpr int kStages = LIFTREG_PCA_GRAD_STAGES;

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

__device__ __forceinline__ void unpack8(const uint4& raw, float v[kCols]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < kCols / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// bytes of one ring buffer: the block's basis rows, then B cotangent rows
__host__ __device__ constexpr int64_t stage_bytes(int64_t rows, int64_t B) {
  return rows * kGradTile * 2 + B * kGradTile * 4;
}

template <int B>
__global__ void __launch_bounds__(kGradMaxWarps * 32)
pca_grad_partial_kernel(const float* __restrict__ g,
                        const __nv_bfloat16* __restrict__ V,
                        float* __restrict__ partial, int64_t L, int64_t n,
                        int vec) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ alignas(8) uint64_t full[kStages];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t block_row0 =
      static_cast<int64_t>(blockIdx.y) * (blockDim.x / 32) * kGradRows;
  const int64_t block_rows_max = (blockDim.x / 32) * kGradRows;
  const int64_t block_rows = L - block_row0 < block_rows_max
                                 ? L - block_row0 : block_rows_max;
  const int64_t row0 = block_row0 + warp * kGradRows;
  // a warp past the last row of a ragged L still takes part in the barriers
  const int rows = row0 >= L ? 0
                   : static_cast<int>(L - row0 < kGradRows ? L - row0
                                                           : kGradRows);
  const int64_t sbytes = stage_bytes(block_rows_max, B);

  float acc[B][kGradRows];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int r = 0; r < kGradRows; ++r) acc[b][r] = 0.f;

  const int64_t tiles = (n + kGradTile - 1) / kGradTile;
  const int64_t mine =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  if (vec) {
    // warp 0 fills buffer k % kStages with tile k: lane 0 arms the barrier
    // with the bytes, then the lanes issue one copy per row each
    auto issue = [&](int64_t k) {
      const int64_t base = (blockIdx.x + k * gridDim.x) * kGradTile;
      const int64_t cols = n - base < kGradTile ? n - base : kGradTile;
      const int s = static_cast<int>(k % kStages);
      unsigned char* buf = ring + s * sbytes;
      uint64_t* bar = &full[s];
      if (lane == 0)
        mbar_expect_tx(bar, static_cast<uint32_t>(
                                (block_rows * 2 + B * 4) * cols));
      __syncwarp();
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      for (int64_t i = lane; i < block_rows + B; i += 32) {
        if (i < block_rows)
          bulk_copy(buf + i * kGradTile * 2, V + (block_row0 + i) * n + base,
                    static_cast<uint32_t>(cols * 2), bar);
        else
          bulk_copy(buf + block_rows_max * kGradTile * 2 +
                        (i - block_rows) * kGradTile * 4,
                    g + (i - block_rows) * n + base,
                    static_cast<uint32_t>(cols * 4), bar);
      }
    };
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (warp == 0)
      for (int64_t k = 0; k < kStages && k < mine; ++k) issue(k);
    for (int64_t k = 0; k < mine; ++k) {
      const int s = static_cast<int>(k % kStages);
      const unsigned char* buf = ring + s * sbytes;
      const int64_t j0 = (blockIdx.x + k * gridDim.x) * kGradTile + lane * kCols;
      mbar_wait(&full[s], static_cast<uint32_t>((k / kStages) & 1));
      if (rows > 0 && j0 < n) {
        const float* gs = reinterpret_cast<const float*>(
            buf + block_rows_max * kGradTile * 2);
        float gv[B][kCols];
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const float4 a =
              *reinterpret_cast<const float4*>(gs + b * kGradTile + lane * kCols);
          const float4 c = *reinterpret_cast<const float4*>(
              gs + b * kGradTile + lane * kCols + 4);
          gv[b][0] = a.x; gv[b][1] = a.y; gv[b][2] = a.z; gv[b][3] = a.w;
          gv[b][4] = c.x; gv[b][5] = c.y; gv[b][6] = c.z; gv[b][7] = c.w;
        }
        const __nv_bfloat16* vs =
            reinterpret_cast<const __nv_bfloat16*>(buf) +
            (warp * kGradRows) * kGradTile + lane * kCols;
#pragma unroll
        for (int r = 0; r < kGradRows; ++r) {
          if (r >= rows) continue;
          float v[kCols];
          unpack8(*reinterpret_cast<const uint4*>(vs + r * kGradTile), v);
#pragma unroll
          for (int b = 0; b < B; ++b)
#pragma unroll
            for (int q = 0; q < kCols; ++q)
              acc[b][r] = fmaf(gv[b][q], v[q], acc[b][r]);
        }
      }
      __syncthreads();  // every warp is done with buffer s
      if (warp == 0 && k + kStages < mine) issue(k + kStages);
    }
  } else {
    const __nv_bfloat16* Vw = V + (rows ? row0 : 0) * n;
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

// the same with one thread per output, each adding every block in turn
__global__ void pca_grad_finish_thread_kernel(const float* __restrict__ partial,
                                              float* __restrict__ dcoefs,
                                              int64_t B, int64_t L,
                                              int64_t blocks) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B * L) return;
  const int64_t b = i / L;
  const int64_t l = i - b * L;
  float t = 0.f;
  for (int64_t k = 0; k < blocks; ++k) t += partial[(k * L + l) * B + b];
  dcoefs[i] = __bfloat162float(__float2bfloat16_rn(t));
}

#ifndef LIFTREG_PCA_GRAD_WARP_FINISH
#define LIFTREG_PCA_GRAD_WARP_FINISH 1
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
  const size_t smem =
      vec ? static_cast<size_t>(kStages * stage_bytes(warps * kGradRows, B))
          : 0;
  cudaError_t err = cudaFuncSetAttribute(
      pca_grad_partial_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  pca_grad_partial_kernel<B><<<grid, warps * 32, smem, stream>>>(
      g, static_cast<const __nv_bfloat16*>(V), partial, L, n, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (LIFTREG_PCA_GRAD_WARP_FINISH) {
    const int64_t threads = B * L * 32;
    pca_grad_finish_kernel<<<static_cast<unsigned>((threads + 255) / 256),
                             256, 0, stream>>>(partial, dcoefs, B, L, blocks);
  } else {
    pca_grad_finish_thread_kernel<<<static_cast<unsigned>((B * L + 255) / 256),
                                    256, 0, stream>>>(partial, dcoefs, B, L,
                                                      blocks);
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
