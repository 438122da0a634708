// Variant of the PCA backward in liftreg_tpu_torch/csrc/pca_expand.cu for
// tools/torch_grad_sweep.py: the dot products on the tensor cores.
//
// dcoefs (B, L) = bf16(g (B, n) @ V (L, n)^T). The cotangent keeps its f32
// precision as two bf16 parts, hi = bf16(g) and lo = bf16(g - hi) (their sum
// is g to ~2^-17), and one mma.sync.m16n8k16 (bf16 in, f32 sums) multiplies
// 16 basis rows by 16 columns of 4 batch rows' (hi, lo) pairs: the B
// fragment's 8 columns are (b, part). The summation index of a product may
// be permuted freely as long as both operands agree, so each lane loads 8
// consecutive basis columns of two rows with one 16-byte load each, straight
// into the A fragment's layout (no shared memory), and the same 8 columns of
// the cotangent. A warp owns kMT * 16 basis rows and streams 32 columns per
// step; its f32 sums stay in the mma accumulators. At the end the block's
// warps write their sums to shared memory, the block adds them in warp order
// into a (blocks, L, B) partial, and a second kernel, one warp per output,
// adds the blocks in a fixed order and rounds to bf16. No float atomics.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

#ifndef LIFTREG_PCA_GRAD_WARPS
#define LIFTREG_PCA_GRAD_WARPS 8
#endif
#ifndef LIFTREG_PCA_GRAD_MT
#define LIFTREG_PCA_GRAD_MT 4
#endif
constexpr int kWarps = LIFTREG_PCA_GRAD_WARPS;  // warps per block
constexpr int kMT = LIFTREG_PCA_GRAD_MT;        // 16-row tiles per warp
constexpr int kRowsPerWarp = kMT * 16;
constexpr int kChunk = 32;  // columns per warp step: 4 lanes x 8

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// the hi (part 0) or lo (part 1) bf16 pair of two f32 values
__device__ __forceinline__ uint32_t split_pair(float x, float y, int part) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
  if (!part) return bf16x2_bits(hi);
  return bf16x2_bits(__floats2bfloat162_rn(x - __low2float(hi),
                                           y - __high2float(hi)));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return bf16x2_bits(__halves2bfloat162(lo, hi));
}

template <int B>
__global__ void __launch_bounds__(kWarps * 32)
pca_grad_partial_kernel(const float* __restrict__ g,
                        const __nv_bfloat16* __restrict__ V,
                        float* __restrict__ partial, int64_t L, int64_t n,
                        int vec) {
  constexpr int NT = (B + 3) / 4;  // n-tiles of 4 batch rows x (hi, lo)
  __shared__ float red[kWarps][kRowsPerWarp][NT * 4];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;  // A rows gid, gid + 8; B column gid
  const int tid = lane & 3;   // 8 columns tid * 8 .. + 8 of each step
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kRowsPerWarp;

  // this lane's basis rows (row0 + mt * 16 + gid + 8 h), clamped to a valid
  // row when past L (their loads are off)
  const __nv_bfloat16* vrow[kMT][2];
  bool rok[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = row0 + mt * 16 + gid + 8 * h;
      rok[mt][h] = r < L;
      vrow[mt][h] = V + (r < L ? r : 0) * n;
    }
  // the B fragment's column gid of n-tile t is batch row 4 t + gid / 2,
  // part gid % 2
  const int part = gid & 1;

  float acc[kMT][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][t][q] = 0.f;

  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t ch = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       ch < chunks; ch += stride) {
    const int64_t j0 = ch * kChunk + tid * 8;
    uint4 a[kMT][2];
    float gv[NT][8];
    if (vec) {
      // n % 8 == 0: a lane's 8 columns are all inside or all outside
      const bool in = j0 < n;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[mt][h] = (in && rok[mt][h])
                         ? __ldg(reinterpret_cast<const uint4*>(
                               vrow[mt][h] + j0))
                         : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int b = 4 * t + (gid >> 1);
        const bool ok = in && b < B;
        const float* gp = g + (ok ? b : 0) * n + j0;
        const float4 x = ok ? __ldg(reinterpret_cast<const float4*>(gp))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 y = ok ? __ldg(reinterpret_cast<const float4*>(gp + 4))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        gv[t][0] = x.x; gv[t][1] = x.y; gv[t][2] = x.z; gv[t][3] = x.w;
        gv[t][4] = y.x; gv[t][5] = y.y; gv[t][6] = y.z; gv[t][7] = y.w;
      }
    } else {
      // scalar path: a length or pointer without 16-byte loads
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat16 e[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            e[q] = (rok[mt][h] && j0 + q < n) ? vrow[mt][h][j0 + q] : zero;
          a[mt][h] = make_uint4(pack_bf16(e[0], e[1]), pack_bf16(e[2], e[3]),
                                pack_bf16(e[4], e[5]), pack_bf16(e[6], e[7]));
        }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int b = 4 * t + (gid >> 1);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          gv[t][q] = (b < B && j0 + q < n) ? g[b * n + j0 + q] : 0.f;
      }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      // columns tid*8 + {0,1 | 2,3} feed k-slots tid*2 + {0,1 | 8,9} of the
      // first mma, columns tid*8 + {4,5 | 6,7} those of the second
      const uint32_t b00 = split_pair(gv[t][0], gv[t][1], part);
      const uint32_t b01 = split_pair(gv[t][2], gv[t][3], part);
      const uint32_t b10 = split_pair(gv[t][4], gv[t][5], part);
      const uint32_t b11 = split_pair(gv[t][6], gv[t][7], part);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const uint32_t a0[4] = {a[mt][0].x, a[mt][1].x, a[mt][0].y,
                                a[mt][1].y};
        const uint32_t a1[4] = {a[mt][0].z, a[mt][1].z, a[mt][0].w,
                                a[mt][1].w};
        mma_bf16(acc[mt][t], a0, b00, b01);
        mma_bf16(acc[mt][t], a1, b10, b11);
      }
    }
  }

  // accumulator q of (mt, t): row mt*16 + gid + 8 (q / 2), column
  // tid * 2 + q % 2, i.e. batch row 4 t + tid, part q % 2
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      red[warp][mt * 16 + gid][t * 4 + tid] = acc[mt][t][0] + acc[mt][t][1];
      red[warp][mt * 16 + gid + 8][t * 4 + tid] =
          acc[mt][t][2] + acc[mt][t][3];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < kRowsPerWarp * B; i += blockDim.x) {
    const int r = i / B;
    const int b = i - r * B;
    if (row0 + r >= L) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][r][b];
    partial[(static_cast<int64_t>(blockIdx.x) * L + row0 + r) * B + b] = s;
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
  for (int off = 16; off > 0; off /= 2) t += __shfl_down_sync(0xffffffffu, t, off);
  if (lane == 0) dcoefs[o] = __bfloat162float(__float2bfloat16_rn(t));
}

template <int B>
cudaError_t launch_grad(const float* g, const void* V, float* partial,
                        float* dcoefs, int64_t L, int64_t n, int vec,
                        int64_t blocks, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>((L + kRowsPerWarp - 1) / kRowsPerWarp));
  pca_grad_partial_kernel<B><<<grid, kWarps * 32, 0, stream>>>(
      g, static_cast<const __nv_bfloat16*>(V), partial, L, n, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t threads = B * L * 32;
  pca_grad_finish_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256,
                           0, stream>>>(partial, dcoefs, B, L, blocks);
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
