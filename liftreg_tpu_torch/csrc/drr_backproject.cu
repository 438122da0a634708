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
// output is 262 MB in f32 (~0.078 ms at 3.35 TB/s) or 131 MB in bf16
// (~0.039 ms); the inputs are under 4 MB, and the separable sum needs ~1.3
// GFLOP (~0.02 ms at 67 TFLOP/s).
//
// The first version gave each output its own thread and split a flat 64-bit
// index with four divisions (~80 integer instructions per output, the same
// order as its measured time), redid the geometry for every batch element,
// loaded four detector taps per output and stored one scalar per output.
// This design:
// - No division per output: the grid is (column groups of all planes k,
//   p * d-chunks), and a thread owns kNH consecutive columns h of one plane
//   k and walks the rows d of its chunk. One division per thread splits k
//   from the column group, one uniform division p from the d-chunk.
// - Vector stores: the kNH = 4 values of a row are stored together (16
//   bytes in f32, 8 in bf16) when the rows allow it (the launcher checks the
//   alignment), else one by one. Each row's u tap and its branch serve the
//   kNH outputs.
// - Geometry once for all B: the thread's v taps (v_pix[p,k,h]) are computed
//   once, each row's u taps once, and used for up to kNB batch elements held
//   in registers.
// - Separable, with the rows kept in registers: the value of detector row m
//   interpolated along v at each column, T[m], is computed once and reused
//   by the next row d when u_pix[p,k,:] advances by less than two detector
//   rows (it increases with d in the reference geometry, so most rows d load
//   one new detector row, two taps per column, instead of four). Any order
//   of coordinates is handled: a row that reuses nothing loads both. The
//   loads of all kNB elements are issued before any is used (a missing
//   element repeats the last one; a tap outside the image reads a clamped
//   index with weight 0), so that no branch orders one load's latency
//   behind another's.
// - Stores straight into the encoder's input: out has a batch stride of its
//   own (a view of channels 1..P of a (B, 1+P, D, W, H) buffer), and each
//   value is stored as f32 or rounded once to bf16 (__float2bfloat16_rn).
//   The f32 and bf16 variants compute the same f32 values.
// - 32-bit indices (the wrapper checks the sizes).
// The compile-time knobs (LIFTREG_LIFT_*) exist for
// tools/torch_drr_sweep.py, which times other settings; the defaults are
// the fastest it measured for bf16 output (PERF.md). On the H100 the f32
// variant is bound by its 262 MB of writes; the bf16 variant by the
// detector loads (the sweep's ablations: without stores the loads alone
// take ~0.09 ms, without loads the bf16 stores ~0.05 ms).
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef LIFTREG_LIFT_NB
#define LIFTREG_LIFT_NB 4
#endif
#ifndef LIFTREG_LIFT_DCHUNK
#define LIFTREG_LIFT_DCHUNK 8
#endif
#ifndef LIFTREG_LIFT_NH
#define LIFTREG_LIFT_NH 4
#endif
#ifndef LIFTREG_LIFT_THREADS
#define LIFTREG_LIFT_THREADS 128
#endif

namespace {

constexpr int kNB = LIFTREG_LIFT_NB;          // batch elements in registers
constexpr int kNH = LIFTREG_LIFT_NH;          // columns h per thread
constexpr int kDChunk = LIFTREG_LIFT_DCHUNK;  // rows d walked by one thread
constexpr int kThreads = LIFTREG_LIFT_THREADS;

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

// NH values to p: together when `vec` (p aligned to the vector, n == NH),
// else the first n one by one
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
      // pairs rounded once each (__floats2bfloat162_rn), NH / 2 words
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
drr_backproject_rows(const float* __restrict__ proj,
                     const float* __restrict__ u_pix,
                     const float* __restrict__ v_pix, T* __restrict__ out,
                     int B, int P, int D, int W, int H, int PW, int PH,
                     int out_bstride, int groups, int dchunks, int vec) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= W * groups) return;
  const int k = j / groups;
  const int h0 = (j - k * groups) * kNH;
  const int nh = min(kNH, H - h0);
  const int p = blockIdx.y / dchunks;
  const int d0 = (blockIdx.y - p * dchunks) * kDChunk;
  const int d1 = min(D, d0 + kDChunk);

  // these columns' v taps (a column past H repeats the last one; it is
  // computed and not stored)
  int c0[kNH], c1[kNH];
  float wv0[kNH], wv1[kNH];
#pragma unroll
  for (int c = 0; c < kNH; ++c) {
    const float vp = __ldg(v_pix + (p * W + k) * H + min(h0 + c, H - 1));
    const int mv0 = floor_tap(vp, PH);
    wv0[c] = (mv0 >= 0 && mv0 < PH) ? tap_weight(vp, mv0) : 0.f;
    wv1[c] = (mv0 + 1 >= 0 && mv0 + 1 < PH) ? tap_weight(vp, mv0 + 1) : 0.f;
    c0[c] = min(max(mv0, 0), PH - 1);
    c1[c] = min(max(mv0 + 1, 0), PH - 1);
  }
  const float* urow = u_pix + (p * W + k) * D;

  for (int b0 = 0; b0 < B; b0 += kNB) {
    const int nb = min(kNB, B - b0);
    // a missing batch element repeats the last one, so that every slot
    // loads and no branch orders one element's loads behind another's
    const float* img[kNB];
#pragma unroll
    for (int bb = 0; bb < kNB; ++bb)
      img[bb] = proj + (min(b0 + bb, B - 1) * P + p) * PW * PH;

    int cached = -4;  // T0 holds row `cached`, T1 row `cached` + 1
    float T0[kNB][kNH], T1[kNB][kNH];
#pragma unroll
    for (int bb = 0; bb < kNB; ++bb)
#pragma unroll
      for (int c = 0; c < kNH; ++c) T0[bb][c] = T1[bb][c] = 0.f;

    for (int d = d0; d < d1; ++d) {
      const float up = __ldg(urow + d);
      const int mu0 = floor_tap(up, PW);
      const float wu0 = (mu0 >= 0 && mu0 < PW) ? tap_weight(up, mu0) : 0.f;
      const float wu1 =
          (mu0 + 1 >= 0 && mu0 + 1 < PW) ? tap_weight(up, mu0 + 1) : 0.f;
      // detector rows m = mu0 and mu0 + 1 interpolated along v at each
      // column; a row outside the image, or a dropped v tap, reads a
      // clamped index with weight 0
      if (mu0 == cached + 1) {
        const bool ok = mu0 + 1 >= 0 && mu0 + 1 < PW;
        const int r = min(max(mu0 + 1, 0), PW - 1) * PH;
        float a[kNB][kNH], e[kNB][kNH];
#pragma unroll
        for (int bb = 0; bb < kNB; ++bb)
#pragma unroll
          for (int c = 0; c < kNH; ++c) {
            a[bb][c] = __ldg(img[bb] + r + c0[c]);
            e[bb][c] = __ldg(img[bb] + r + c1[c]);
          }
#pragma unroll
        for (int bb = 0; bb < kNB; ++bb)
#pragma unroll
          for (int c = 0; c < kNH; ++c) {
            T0[bb][c] = T1[bb][c];
            T1[bb][c] = ok ? fmaf(wv1[c], e[bb][c], wv0[c] * a[bb][c]) : 0.f;
          }
      } else if (mu0 != cached) {
        const bool ok0 = mu0 >= 0 && mu0 < PW;
        const bool ok1 = mu0 + 1 >= 0 && mu0 + 1 < PW;
        const int r0 = min(max(mu0, 0), PW - 1) * PH;
        const int r1 = min(max(mu0 + 1, 0), PW - 1) * PH;
        float a0[kNB][kNH], e0[kNB][kNH], a1[kNB][kNH], e1[kNB][kNH];
#pragma unroll
        for (int bb = 0; bb < kNB; ++bb)
#pragma unroll
          for (int c = 0; c < kNH; ++c) {
            a0[bb][c] = __ldg(img[bb] + r0 + c0[c]);
            e0[bb][c] = __ldg(img[bb] + r0 + c1[c]);
            a1[bb][c] = __ldg(img[bb] + r1 + c0[c]);
            e1[bb][c] = __ldg(img[bb] + r1 + c1[c]);
          }
#pragma unroll
        for (int bb = 0; bb < kNB; ++bb)
#pragma unroll
          for (int c = 0; c < kNH; ++c) {
            T0[bb][c] =
                ok0 ? fmaf(wv1[c], e0[bb][c], wv0[c] * a0[bb][c]) : 0.f;
            T1[bb][c] =
                ok1 ? fmaf(wv1[c], e1[bb][c], wv0[c] * a1[bb][c]) : 0.f;
          }
      }
      cached = mu0;
      T* row = out + (p * D + d) * W * H + k * H + h0;
#pragma unroll
      for (int bb = 0; bb < kNB; ++bb) {
        if (bb >= nb) break;
        float v[kNH];
#pragma unroll
        for (int c = 0; c < kNH; ++c)
          v[c] = fmaf(wu1, T1[bb][c], fmaf(wu0, T0[bb][c], 0.f));
        store_cols<kNH>(row + (b0 + bb) * out_bstride, v,
                       vec && nh == kNH, nh);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const float* proj, const float* u_pix, const float* v_pix,
                   void* out, int B, int P, int D, int W, int H, int PW,
                   int PH, int out_bstride, cudaStream_t stream) {
  const int groups = (H + kNH - 1) / kNH;
  const int dchunks = (D + kDChunk - 1) / kDChunk;
  // the vector stores need every row start aligned to kNH values
  const bool vec =
      reinterpret_cast<uintptr_t>(out) % (kNH * sizeof(T)) == 0 &&
      H % kNH == 0 && (B == 1 || out_bstride % kNH == 0);
  const dim3 grid(static_cast<unsigned>((W * groups + kThreads - 1) /
                                        kThreads),
                  static_cast<unsigned>(P * dchunks));
  drr_backproject_rows<T><<<grid, kThreads, 0, stream>>>(
      proj, u_pix, v_pix, static_cast<T*>(out), B, P, D, W, H, PW, PH,
      out_bstride, groups, dchunks, vec);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// proj (B, P, PW, PH), u_pix (P, W, D), v_pix (P, W, H), all f32 and
// contiguous; out holds B blocks of (P, D, W, H) values, block b starting at
// out + b * out_bstride, f32 or (out_bf16) bf16. Every index is below 2^31
// (the wrapper checks).
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
