// Variant of the PCA backward in liftreg_tpu_torch/csrc/pca_expand.cu for
// tools/torch_grad_sweep.py: the cotangent through L1 (__ldg) instead of
// staged in shared memory by the TMA, and one thread per output in the
// second pass. Same entry point (liftreg_pca_grad), same arithmetic in the
// same order, so the same bits. LIFTREG_PCA_GRAD_ROWS sets the basis rows
// per warp, LIFTREG_PCA_GRAD_PREFETCH=1 loads the next tile's operands
// before the current tile is used.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 8;  // columns per lane: one 16-byte load of bf16

// As in csrc/, each warp owns kGradRows basis rows and each lane 8 columns
// of a 256-column tile, with B x kGradRows f32 sums in registers, one
// reduction across the lanes per block, and a (blocks, L, B) partial summed
// in block order by a second kernel.
#ifndef LIFTREG_PCA_GRAD_ROWS
#define LIFTREG_PCA_GRAD_ROWS 8
#endif
#ifndef LIFTREG_PCA_GRAD_PREFETCH
#define LIFTREG_PCA_GRAD_PREFETCH 0
#endif
constexpr int kGradRows = LIFTREG_PCA_GRAD_ROWS;  // basis rows per warp
constexpr int kGradMaxWarps = 8;
constexpr int kGradTile = 32 * kCols;  // columns per tile: 8 per lane
// 1: a lane loads the next tile's basis rows and cotangent before it uses
// the current tile's
constexpr bool kGradPrefetch = LIFTREG_PCA_GRAD_PREFETCH != 0;

__device__ __forceinline__ void unpack8(const uint4& raw, float v[kCols]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < kCols / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// One tile's operands of a lane: its 8 columns of the warp's basis rows and
// of the B cotangent rows (zeros past the end)
template <int B>
struct GradTile {
  uint4 raw[kGradRows];
  float4 gv[B][2];
};

template <int B>
__device__ __forceinline__ void load_grad_tile(
    GradTile<B>& t, const float* __restrict__ g,
    const __nv_bfloat16* __restrict__ Vw, int rows, int64_t n, int64_t j0) {
  const bool in = j0 < n;
#pragma unroll
  for (int r = 0; r < kGradRows; ++r)
    t.raw[r] = (r < rows && in)
                   ? __ldg(reinterpret_cast<const uint4*>(Vw + r * n + j0))
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int b = 0; b < B; ++b) {
    t.gv[b][0] = in ? __ldg(reinterpret_cast<const float4*>(g + b * n + j0))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    t.gv[b][1] = in ? __ldg(reinterpret_cast<const float4*>(g + b * n + j0 + 4))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int B>
__device__ __forceinline__ void accumulate_tile(const GradTile<B>& t,
                                                float (&acc)[B][kGradRows]) {
#pragma unroll
  for (int r = 0; r < kGradRows; ++r) {
    float v[kCols];
    unpack8(t.raw[r], v);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const float gk[kCols] = {t.gv[b][0].x, t.gv[b][0].y, t.gv[b][0].z,
                               t.gv[b][0].w, t.gv[b][1].x, t.gv[b][1].y,
                               t.gv[b][1].z, t.gv[b][1].w};
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[b][r] = fmaf(gk[k], v[k], acc[b][r]);
    }
  }
}

template <int B>
__global__ void __launch_bounds__(kGradMaxWarps * 32)
pca_grad_partial_kernel(const float* __restrict__ g,
                        const __nv_bfloat16* __restrict__ V,
                        float* __restrict__ partial, int64_t L, int64_t n,
                        int vec) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row0 =
      (static_cast<int64_t>(blockIdx.y) * (blockDim.x / 32) + warp) *
      kGradRows;
  if (row0 >= L) return;  // a warp past the last row of a ragged L
  const int rows = static_cast<int>(L - row0 < kGradRows ? L - row0
                                                         : kGradRows);
  const __nv_bfloat16* Vw = V + row0 * n;

  float acc[B][kGradRows];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int r = 0; r < kGradRows; ++r) acc[b][r] = 0.f;

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kGradTile;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kGradTile;
  if (vec) {
    // n % 8 == 0: a lane's 8 columns are all inside or all outside
    GradTile<B> next;
    if (kGradPrefetch) load_grad_tile(next, g, Vw, rows, n, first + lane * kCols);
    for (int64_t base = first; base < n; base += stride) {
      GradTile<B> cur;
      if (kGradPrefetch) {
        cur = next;
        load_grad_tile(next, g, Vw, rows, n, base + stride + lane * kCols);
      } else {
        load_grad_tile(cur, g, Vw, rows, n, base + lane * kCols);
      }
      accumulate_tile(cur, acc);
    }
  } else {
    // scalar path: a length or pointer without 16-byte loads
    for (int64_t base = first; base < n; base += stride) {
      const int64_t j0 = base + lane * kCols;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        if (j0 + k >= n) continue;
        float gk[B];
#pragma unroll
        for (int b = 0; b < B; ++b) gk[b] = g[b * n + j0 + k];
#pragma unroll
        for (int r = 0; r < kGradRows; ++r) {
          if (r >= rows) continue;
          const float v = __bfloat162float(Vw[r * n + j0 + k]);
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
  const int64_t outs = B * L;
  pca_grad_finish_kernel<<<static_cast<unsigned>((outs + 255) / 256), 256, 0,
                           stream>>>(partial, dcoefs, B, L, blocks);
  return cudaGetLastError();
}

}  // namespace

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

extern "C" const char* liftreg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
