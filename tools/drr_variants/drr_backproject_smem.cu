// Variant of liftreg_tpu_torch/csrc/drr_backproject.cu for
// tools/torch_drr_sweep.py: the detector footprint of a block is staged in
// shared memory. Same entry point, same values bit for bit (the same
// clamped indices, weights and operation order).
//
// A block owns kKB planes k and kDB rows d of one view p, for every column
// h. Its prologue reduces the detector rows and columns that those outputs
// read (clamped to the image): about 21 rows and 223 columns at the serving
// shape. For each batch element in turn, the block copies that rectangle of
// the projection into shared memory with coalesced loads (a warp per row,
// kStage loads in flight per lane), then each thread
// computes kNH consecutive columns of one plane k over the kDB rows from
// shared memory (the rows reused along d in registers, as in csrc/), and
// stores them together. The L2-to-SM traffic falls from one detector span
// per output row and batch element to one footprint per block and batch
// element (by count, ~80 MB instead of ~500 MB at the serving shape), at
// the price of two barriers per batch element. A block whose footprint
// exceeds the buffer reads the projection from global memory instead.
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef LIFTREG_LIFT_KB
#define LIFTREG_LIFT_KB 8
#endif
#ifndef LIFTREG_LIFT_DB
#define LIFTREG_LIFT_DB 16
#endif
#ifndef LIFTREG_LIFT_NH
#define LIFTREG_LIFT_NH 4
#endif
#ifndef LIFTREG_LIFT_THREADS
#define LIFTREG_LIFT_THREADS 320
#endif
#ifndef LIFTREG_LIFT_SMEM_FLOATS
#define LIFTREG_LIFT_SMEM_FLOATS 8192
#endif

namespace {

constexpr int kKB = LIFTREG_LIFT_KB;          // planes k per block
constexpr int kDB = LIFTREG_LIFT_DB;          // rows d per block
constexpr int kNH = LIFTREG_LIFT_NH;          // columns h per thread
constexpr int kThreads = LIFTREG_LIFT_THREADS;
constexpr int kCap = LIFTREG_LIFT_SMEM_FLOATS;  // staged footprint, floats
constexpr int kStage = 8;  // columns a lane loads before it stores any

__device__ __forceinline__ float tap_weight(float pix, int m) {
  return fmaxf(0.f, 1.f - fabsf(pix - static_cast<float>(m)));
}

__device__ __forceinline__ int floor_tap(float pix, int n) {
  return static_cast<int>(
      floorf(fminf(fmaxf(pix, -2.f), static_cast<float>(n + 1))));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int NH>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[NH],
                                           bool vec, int n) {
  if constexpr (NH % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int c = 0; c < NH; c += 4)
        *reinterpret_cast<float4*>(p + c) =
            make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
      return;
    }
  } else if constexpr (NH == 2) {
    if (vec) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < NH; ++c)
    if (c < n) store1(p + c, v[c]);
}

template <int NH>
__device__ __forceinline__ void store_cols(__nv_bfloat16* p,
                                           const float (&v)[NH], bool vec,
                                           int n) {
  if constexpr (NH % 2 == 0) {
    if (vec) {
      uint32_t w[NH / 2];
#pragma unroll
      for (int c = 0; c < NH; c += 2) {
        const __nv_bfloat162 pr = __floats2bfloat162_rn(v[c], v[c + 1]);
        memcpy(&w[c / 2], &pr, 4);
      }
      if constexpr (NH % 8 == 0) {
#pragma unroll
        for (int c = 0; c < NH / 2; c += 4)
          *reinterpret_cast<uint4*>(p + 2 * c) =
              make_uint4(w[c], w[c + 1], w[c + 2], w[c + 3]);
      } else if constexpr (NH % 4 == 0) {
#pragma unroll
        for (int c = 0; c < NH / 2; c += 2)
          *reinterpret_cast<uint2*>(p + 2 * c) = make_uint2(w[c], w[c + 1]);
      } else {
        *reinterpret_cast<uint32_t*>(p) = w[0];
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < NH; ++c)
    if (c < n) store1(p + c, v[c]);
}

// kNH columns of plane k, rows d0..d1-1, of batch element b: the detector
// values come from src[(r - r0) * stride + (c - c0)] for the clamped row r
// and column c (shared memory or the projection itself)
template <typename T>
__device__ __forceinline__ void lift_item(
    const float* __restrict__ src, int stride, int r0, int c0,
    const float* __restrict__ urow, const float* __restrict__ vrow, T* row0,
    int k, int h0, int nh, int d0, int d1, int W, int H, int PW, int PH,
    bool vec) {
  int ca[kNH], cb[kNH];
  float wv0[kNH], wv1[kNH];
#pragma unroll
  for (int c = 0; c < kNH; ++c) {
    const float vp = __ldg(vrow + min(h0 + c, H - 1));
    const int mv0 = floor_tap(vp, PH);
    wv0[c] = (mv0 >= 0 && mv0 < PH) ? tap_weight(vp, mv0) : 0.f;
    wv1[c] = (mv0 + 1 >= 0 && mv0 + 1 < PH) ? tap_weight(vp, mv0 + 1) : 0.f;
    ca[c] = min(max(mv0, 0), PH - 1) - c0;
    cb[c] = min(max(mv0 + 1, 0), PH - 1) - c0;
  }
  int cached = -4;  // T0 holds row `cached`, T1 row `cached` + 1
  float T0[kNH], T1[kNH];
#pragma unroll
  for (int c = 0; c < kNH; ++c) T0[c] = T1[c] = 0.f;
  for (int d = d0; d < d1; ++d) {
    const float up = __ldg(urow + d);
    const int mu0 = floor_tap(up, PW);
    const float wu0 = (mu0 >= 0 && mu0 < PW) ? tap_weight(up, mu0) : 0.f;
    const float wu1 =
        (mu0 + 1 >= 0 && mu0 + 1 < PW) ? tap_weight(up, mu0 + 1) : 0.f;
    if (mu0 == cached + 1) {
      const bool ok = mu0 + 1 >= 0 && mu0 + 1 < PW;
      const float* s = src + (min(max(mu0 + 1, 0), PW - 1) - r0) * stride;
#pragma unroll
      for (int c = 0; c < kNH; ++c) {
        T0[c] = T1[c];
        T1[c] = ok ? fmaf(wv1[c], s[cb[c]], wv0[c] * s[ca[c]]) : 0.f;
      }
    } else if (mu0 != cached) {
      const bool ok0 = mu0 >= 0 && mu0 < PW;
      const bool ok1 = mu0 + 1 >= 0 && mu0 + 1 < PW;
      const float* s0 = src + (min(max(mu0, 0), PW - 1) - r0) * stride;
      const float* s1 = src + (min(max(mu0 + 1, 0), PW - 1) - r0) * stride;
#pragma unroll
      for (int c = 0; c < kNH; ++c) {
        T0[c] = ok0 ? fmaf(wv1[c], s0[cb[c]], wv0[c] * s0[ca[c]]) : 0.f;
        T1[c] = ok1 ? fmaf(wv1[c], s1[cb[c]], wv0[c] * s1[ca[c]]) : 0.f;
      }
    }
    cached = mu0;
    float v[kNH];
#pragma unroll
    for (int c = 0; c < kNH; ++c)
      v[c] = fmaf(wu1, T1[c], fmaf(wu0, T0[c], 0.f));
    store_cols<kNH>(row0 + d * W * H + k * H + h0, v, vec && nh == kNH, nh);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
drr_backproject_staged(const float* __restrict__ proj,
                       const float* __restrict__ u_pix,
                       const float* __restrict__ v_pix, T* __restrict__ out,
                       int B, int P, int D, int W, int H, int PW, int PH,
                       int out_bstride, int groups, int dtiles, int vec) {
  __shared__ float buf[kCap];
  __shared__ int bounds[4];  // row lo, row hi, column lo, column hi
  const int k0 = blockIdx.x * kKB;
  const int k1 = min(W, k0 + kKB);
  const int p = blockIdx.y / dtiles;
  const int d0 = (blockIdx.y - p * dtiles) * kDB;
  const int d1 = min(D, d0 + kDB);
  const int items = (k1 - k0) * groups;

  // the prologue: the clamped detector rows and columns that the block's
  // outputs read
  if (threadIdx.x == 0) {
    bounds[0] = bounds[2] = INT32_MAX;
    bounds[1] = bounds[3] = INT32_MIN;
  }
  __syncthreads();
  int rlo = INT32_MAX, rhi = INT32_MIN, clo = INT32_MAX, chi = INT32_MIN;
  for (int e = threadIdx.x; e < (k1 - k0) * (d1 - d0); e += kThreads) {
    const int kk = e / (d1 - d0);
    const int m = floor_tap(
        __ldg(u_pix + (p * W + k0 + kk) * D + d0 + e - kk * (d1 - d0)), PW);
    rlo = min(rlo, min(max(m, 0), PW - 1));
    rhi = max(rhi, min(max(m + 1, 0), PW - 1));
  }
  for (int e = threadIdx.x; e < (k1 - k0) * H; e += kThreads) {
    const int m = floor_tap(__ldg(v_pix + (p * W + k0) * H + e), PH);
    clo = min(clo, min(max(m, 0), PH - 1));
    chi = max(chi, min(max(m + 1, 0), PH - 1));
  }
  rlo = __reduce_min_sync(0xffffffffu, rlo);
  rhi = __reduce_max_sync(0xffffffffu, rhi);
  clo = __reduce_min_sync(0xffffffffu, clo);
  chi = __reduce_max_sync(0xffffffffu, chi);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&bounds[0], rlo);
    atomicMax(&bounds[1], rhi);
    atomicMin(&bounds[2], clo);
    atomicMax(&bounds[3], chi);
  }
  __syncthreads();
  const int r0 = bounds[0], c0 = bounds[2];
  const int nrows = bounds[1] - r0 + 1, ncols = bounds[3] - c0 + 1;
  const bool fits = nrows * ncols <= kCap;

  for (int b = 0; b < B; ++b) {
    const float* img = proj + (b * P + p) * PW * PH;
    T* row0 = out + b * out_bstride + p * D * W * H;
    if (fits) {
      // a warp per footprint row; each lane loads kStage columns before
      // it stores any, so that their latencies overlap
      for (int r = threadIdx.x / 32; r < nrows; r += kThreads / 32) {
        const float* src = img + (r0 + r) * PH + c0;
        float* dst = buf + r * ncols;
        for (int cb = threadIdx.x % 32; cb < ncols; cb += 32 * kStage) {
          float v[kStage];
#pragma unroll
          for (int q = 0; q < kStage; ++q)
            v[q] = cb + 32 * q < ncols ? __ldg(src + cb + 32 * q) : 0.f;
#pragma unroll
          for (int q = 0; q < kStage; ++q)
            if (cb + 32 * q < ncols) dst[cb + 32 * q] = v[q];
        }
      }
      __syncthreads();
      for (int it = threadIdx.x; it < items; it += kThreads) {
        const int kk = it / groups;
        const int h0 = (it - kk * groups) * kNH;
        lift_item<T>(buf, ncols, r0, c0, u_pix + (p * W + k0 + kk) * D,
                     v_pix + (p * W + k0 + kk) * H, row0, k0 + kk, h0,
                     min(kNH, H - h0), d0, d1, W, H, PW, PH, vec);
      }
      __syncthreads();  // the buffer is free for the next element
    } else {
      for (int it = threadIdx.x; it < items; it += kThreads) {
        const int kk = it / groups;
        const int h0 = (it - kk * groups) * kNH;
        lift_item<T>(img, PH, 0, 0, u_pix + (p * W + k0 + kk) * D,
                     v_pix + (p * W + k0 + kk) * H, row0, k0 + kk, h0,
                     min(kNH, H - h0), d0, d1, W, H, PW, PH, vec);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const float* proj, const float* u_pix, const float* v_pix,
                   void* out, int B, int P, int D, int W, int H, int PW,
                   int PH, int out_bstride, cudaStream_t stream) {
  const int groups = (H + kNH - 1) / kNH;
  const int dtiles = (D + kDB - 1) / kDB;
  const bool vec =
      reinterpret_cast<uintptr_t>(out) % (kNH * sizeof(T)) == 0 &&
      H % kNH == 0 && (B == 1 || out_bstride % kNH == 0);
  const dim3 grid(static_cast<unsigned>((W + kKB - 1) / kKB),
                  static_cast<unsigned>(P * dtiles));
  drr_backproject_staged<T><<<grid, kThreads, 0, stream>>>(
      proj, u_pix, v_pix, static_cast<T*>(out), B, P, D, W, H, PW, PH,
      out_bstride, groups, dtiles, vec);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// Arguments as in csrc/drr_backproject.cu.
extern "C" int liftreg_drr_backproject(const float* proj, const float* u_pix,
                                       const float* v_pix, void* out,
                                       int out_bf16, int64_t out_bstride,
                                       int64_t B, int64_t P, int64_t D,
                                       int64_t W, int64_t H, int64_t PW,
                                       int64_t PH, void* stream) {
  if (B * P * D * W * H == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int args[] = {static_cast<int>(B),  static_cast<int>(P),
                      static_cast<int>(D),  static_cast<int>(W),
                      static_cast<int>(H),  static_cast<int>(PW),
                      static_cast<int>(PH), static_cast<int>(out_bstride)};
  if (out_bf16)
    return static_cast<int>(launch<__nv_bfloat16>(
        proj, u_pix, v_pix, out, args[0], args[1], args[2], args[3], args[4],
        args[5], args[6], args[7], s));
  return static_cast<int>(launch<float>(proj, u_pix, v_pix, out, args[0],
                                        args[1], args[2], args[3], args[4],
                                        args[5], args[6], args[7], s));
}
