// Variant of liftreg_tpu_torch/csrc/drr_project.cu for
// tools/torch_drr_sweep.py: a block interpolates kPPP planes per phase:
// the z passes of the next kPPP planes that are not skipped, one barrier,
// their x passes in plane order, one barrier. Same entry point, same
// values (the planes are added in the same order). S holds kPPP planes.
#include <cstdint>

#include <cuda_runtime.h>

// Compile-time knobs, as in csrc/, plus the planes per phase. The tile's
// rows must be a power of two <= 32 and a multiple of the warps.
#ifndef LIFTREG_PROJ_TI
#define LIFTREG_PROJ_TI 16
#endif
#ifndef LIFTREG_PROJ_WARPS
#define LIFTREG_PROJ_WARPS 4
#endif
#ifndef LIFTREG_PROJ_PLANES_PER_PHASE
#define LIFTREG_PROJ_PLANES_PER_PHASE 2
#endif
#ifndef LIFTREG_PROJ_SLOT_BATCH
#define LIFTREG_PROJ_SLOT_BATCH 2
#endif

namespace {

constexpr int kTI = LIFTREG_PROJ_TI;   // tile rows (detector i), <= 32
constexpr int kTJ = 32;               // tile columns (detector j), one per lane
constexpr int kNB = 4;                // batch elements per block
constexpr int kWarps = LIFTREG_PROJ_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 2 * kTI;       // S rows
constexpr int kRowsPerWarp = kTI / kWarps;
constexpr int kPPP = LIFTREG_PROJ_PLANES_PER_PHASE;  // planes per phase
constexpr int kSlotBatch = LIFTREG_PROJ_SLOT_BATCH;  // slots loaded together
constexpr int kMaxPlanes = 64;        // planes per block (the wrapper splits)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float tap_weight(float pix, int m) {
  return fmaxf(0.f, 1.f - fabsf(pix - static_cast<float>(m)));
}

// floor of a coordinate, clamped to [-2, n + 1] first so that the int stays
// in range; both taps of a clamped coordinate fall outside [0, n-1]
__device__ __forceinline__ int floor_tap(float pix, int n) {
  return static_cast<int>(
      floorf(fminf(fmaxf(pix, -2.f), static_cast<float>(n + 1))));
}

// the per-plane data that a block shares: its tile's coordinates, and the
// row range and skip flag of each plane, computed once in the prologue
struct PlaneTable {
  float x[kMaxPlanes][kTI];  // rows past RD repeat the last valid row
  float z[kMaxPlanes][kTJ];  // columns past RH repeat the last valid column
  int lo[kMaxPlanes], hi[kMaxPlanes], skip[kMaxPlanes];
};

__global__ void __launch_bounds__(kThreads)
drr_project_tiles(const float* __restrict__ vol,
                  const float* __restrict__ x_pix,
                  const float* __restrict__ z_pix,
                  const float* __restrict__ dx, float* __restrict__ out,
                  int B, int P, int D, int W, int H, int RD, int RH,
                  int bchunks, int kper, int final_pass) {
  static_assert(kNB == 4, "S holds the batch elements as one float4");
  __shared__ float4 S[kPPP][kSlots][kTJ];
  __shared__ PlaneTable tab;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i0 = blockIdx.y * kTI;
  const int j = blockIdx.x * kTJ + lane;
  int z = blockIdx.z;
  const int p = z % P;
  z /= P;
  const int b0 = (z % bchunks) * kNB;
  const int ks = z / bchunks;
  const int nb = min(kNB, B - b0);
  const int k_begin = ks * kper;
  const int k_end = min(W, k_begin + kper);
  const bool jvalid = j < RH;

  int bstart[kNB];
#pragma unroll
  for (int bb = 0; bb < kNB; ++bb) bstart[bb] = min(b0 + bb, B - 1);

  float acc[kRowsPerWarp][kNB];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int bb = 0; bb < kNB; ++bb) acc[r][bb] = 0.f;

  // the prologue: every plane's coordinates into shared memory, then per
  // plane the tile's row range and whether any tap hits the volume
  const int np = k_end - k_begin;
  for (int e = threadIdx.x; e < np * kTI; e += kThreads) {
    const int kk = e / kTI;
    const int r = e - kk * kTI;
    tab.x[kk][r] = __ldg(x_pix + (p * W + k_begin + kk) * RD +
                         min(i0 + r, RD - 1));
  }
  for (int e = threadIdx.x; e < np * kTJ; e += kThreads) {
    const int kk = e / kTJ;
    const int c = e - kk * kTJ;
    tab.z[kk][c] = __ldg(z_pix + (p * W + k_begin + kk) * RH +
                         min(static_cast<int>(blockIdx.x) * kTJ + c, RH - 1));
  }
  __syncthreads();
  for (int kk = warp; kk < np; kk += kWarps) {
    const int m = floor_tap(tab.x[kk][lane & (kTI - 1)], D);
    const int lo = __reduce_min_sync(kFull, m);
    const int hi = __reduce_max_sync(kFull, m);
    const float zp = tab.z[kk][lane];
    const int mz0 = floor_tap(zp, H);
    const bool hit = jvalid && ((mz0 >= 0 && mz0 < H &&
                                 tap_weight(zp, mz0) != 0.f) ||
                                (mz0 + 1 >= 0 && mz0 + 1 < H &&
                                 tap_weight(zp, mz0 + 1) != 0.f));
    const bool any_col = __any_sync(kFull, hit);
    if (lane == 0) {
      tab.lo[kk] = lo;
      tab.hi[kk] = hi;
      // a plane whose taps all miss the volume adds exactly nothing
      tab.skip[kk] = hi + 1 < 0 || lo > D - 1 || !any_col;
    }
  }
  __syncthreads();

  // phases of up to kPPP planes that are not skipped: one z pass for all of
  // them, a barrier, one x pass in plane order, a barrier
  int kk_next = 0;
  for (;;) {
    int kks[kPPP];
    int n = 0;
    while (n < kPPP && kk_next < np) {
      if (!tab.skip[kk_next]) kks[n++] = kk_next;
      ++kk_next;
    }
    if (n == 0) break;  // the same for the whole block
    int mx0[kPPP], lo[kPPP], nslots[kPPP];
    float wx0[kPPP], wx1[kPPP];
    bool contiguous[kPPP];
#pragma unroll
    for (int j = 0; j < kPPP; ++j) {
      if (j >= n) break;
      const int kk = kks[j];
      const int k = k_begin + kk;
      // x taps of the tile's rows (lanes 0..15) and their row range
      const float xp = tab.x[kk][lane & (kTI - 1)];
      mx0[j] = floor_tap(xp, D);
      wx0[j] = (mx0[j] >= 0 && mx0[j] < D) ? tap_weight(xp, mx0[j]) : 0.f;
      wx1[j] = (mx0[j] + 1 >= 0 && mx0[j] + 1 < D)
                   ? tap_weight(xp, mx0[j] + 1) : 0.f;
      lo[j] = tab.lo[kk];
      contiguous[j] = tab.hi[kk] - lo[j] + 2 <= kSlots;
      nslots[j] = contiguous[j] ? tab.hi[kk] - lo[j] + 2 : kSlots;
      // z taps of this lane's column; a dropped tap reads a clamped index
      // with weight 0, which adds exactly nothing
      const float zp = tab.z[kk][lane];
      const int mz0 = floor_tap(zp, H);
      const float wz0 = (jvalid && mz0 >= 0 && mz0 < H) ? tap_weight(zp, mz0)
                                                        : 0.f;
      const float wz1 = (jvalid && mz0 + 1 >= 0 && mz0 + 1 < H)
                            ? tap_weight(zp, mz0 + 1) : 0.f;
      const float* col0 = vol + k * H + min(max(mz0, 0), H - 1);
      const float* col1 = vol + k * H + min(max(mz0 + 1, 0), H - 1);
      for (int s0 = warp; s0 < nslots[j]; s0 += kWarps * kSlotBatch) {
        float a[kSlotBatch][kNB], c[kSlotBatch][kNB];
#pragma unroll
        for (int q = 0; q < kSlotBatch; ++q) {
          const int s = s0 + kWarps * q;
          const int row = contiguous[j]
                              ? lo[j] + s
                              : __shfl_sync(kFull, mx0[j], (s >> 1) & 31) +
                                    (s & 1);
          const int rc = min(max(row, 0), D - 1);
#pragma unroll
          for (int bb = 0; bb < kNB; ++bb) {
            const int o = (bstart[bb] * D + rc) * W * H;
            a[q][bb] = __ldg(col0 + o);
            c[q][bb] = __ldg(col1 + o);
          }
        }
#pragma unroll
        for (int q = 0; q < kSlotBatch; ++q) {
          const int s = s0 + kWarps * q;
          if (s >= nslots[j]) break;
          const int row = contiguous[j]
                              ? lo[j] + s
                              : __shfl_sync(kFull, mx0[j], (s >> 1) & 31) +
                                    (s & 1);
          const bool rok = row >= 0 && row < D;
          float v[kNB];
#pragma unroll
          for (int bb = 0; bb < kNB; ++bb)
            v[bb] = rok ? fmaf(wz1, c[q][bb], wz0 * a[q][bb]) : 0.f;
          S[j][s][lane] = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    __syncthreads();

    // each output row interpolates S along x, plane by plane
#pragma unroll
    for (int j = 0; j < kPPP; ++j) {
      if (j >= n) break;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int il = warp + kWarps * r;
        const int m0 = __shfl_sync(kFull, mx0[j], il);
        const float w0 = __shfl_sync(kFull, wx0[j], il);
        const float w1 = __shfl_sync(kFull, wx1[j], il);
        if (i0 + il >= RD) continue;
        const int s0 = contiguous[j] ? m0 - lo[j] : 2 * il;
        const float4 a4 = S[j][s0][lane], c4 = S[j][s0 + 1][lane];
        const float a[kNB] = {a4.x, a4.y, a4.z, a4.w};
        const float c[kNB] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int bb = 0; bb < kNB; ++bb) {
          acc[r][bb] = fmaf(w0, a[bb], acc[r][bb]);
          acc[r][bb] = fmaf(w1, c[bb], acc[r][bb]);
        }
      }
    }
    __syncthreads();
  }

  if (!jvalid) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int ir = i0 + warp + kWarps * r;
    if (ir >= RD) continue;
    const int pix = ir * RH + j;
#pragma unroll
    for (int bb = 0; bb < kNB; ++bb) {
      if (bb >= nb) break;
      const int o = ((b0 + bb) * P + p) * RD * RH + pix;
      if (final_pass)
        out[o] = acc[r][bb] * __ldg(dx + p * RD * RH + pix) * 0.1f;
      else
        out[ks * B * P * RD * RH + o] = acc[r][bb];
    }
  }
}

// out[b,p,:] = 0.1 * dx[p] * sum over chunks of part[chunk, b, p, :], the
// chunks added in order
__global__ void drr_project_sum(const float* __restrict__ part,
                                const float* __restrict__ dx,
                                float* __restrict__ out, int total,
                                int per_view, int P, int ksplit) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  float acc = part[o];
  for (int s = 1; s < ksplit; ++s) acc += part[s * total + o];
  const int pix = o % per_view;
  const int p = (o / per_view) % P;
  out[o] = acc * __ldg(dx + p * per_view + pix) * 0.1f;
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// vol (B, D, W, H), x_pix (P, W, RD), z_pix (P, W, RH), dx (P, RD, RH),
// out (B, P, RD, RH); all f32 and contiguous, every index below 2^31 (the
// wrapper checks). With ksplit > 1, part holds ksplit * B * P * RD * RH f32
// of scratch for the chunks' partial sums; with ksplit = 1 it is unused.
extern "C" int liftreg_drr_project(const float* vol, const float* x_pix,
                                   const float* z_pix, const float* dx,
                                   float* out, float* part, int64_t B,
                                   int64_t P, int64_t D, int64_t W, int64_t H,
                                   int64_t RD, int64_t RH, int64_t ksplit,
                                   void* stream) {
  if (B * P * RD * RH == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bchunks = static_cast<int>((B + kNB - 1) / kNB);
  const int kper = static_cast<int>((W + ksplit - 1) / ksplit);
  const int chunks = W == 0 ? 1 : static_cast<int>((W + kper - 1) / kper);
  const dim3 grid(static_cast<unsigned>((RH + kTJ - 1) / kTJ),
                  static_cast<unsigned>((RD + kTI - 1) / kTI),
                  static_cast<unsigned>(P * bchunks * chunks));
  if (kper > kMaxPlanes) return static_cast<int>(cudaErrorInvalidValue);
  const int final_pass = chunks == 1;
  drr_project_tiles<<<grid, kThreads, 0, s>>>(
      vol, x_pix, z_pix, dx, final_pass ? out : part, static_cast<int>(B),
      static_cast<int>(P), static_cast<int>(D), static_cast<int>(W),
      static_cast<int>(H), static_cast<int>(RD), static_cast<int>(RH),
      bchunks, kper == 0 ? 1 : kper, final_pass);
  if (!final_pass) {
    const int total = static_cast<int>(B * P * RD * RH);
    drr_project_sum<<<(total + 255) / 256, 256, 0, s>>>(
        part, dx, out, total, static_cast<int>(RD * RH), static_cast<int>(P),
        chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
