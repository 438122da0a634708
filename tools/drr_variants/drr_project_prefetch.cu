// Variant of liftreg_tpu_torch/csrc/drr_project.cu for
// tools/torch_drr_sweep.py: planes in a software pipeline. A warp issues
// all loads of plane k+1's z pass (every slot, every batch element; a row
// outside the volume reads a clamped row) into registers before plane k's
// x pass, and stores them into S only after the barrier that frees S, so
// that the loads' latency overlaps the x pass. Same entry point, same
// values. The loads held across the x pass cost registers: the block's
// resident count is set with LIFTREG_PROJ_MIN_BLOCKS (__launch_bounds__),
// which caps them.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTI = 16;               // tile rows (detector i)
constexpr int kTJ = 32;               // tile columns (detector j), one per lane
constexpr int kNB = 4;                // batch elements per block
#ifndef LIFTREG_PROJ_WARPS
#define LIFTREG_PROJ_WARPS 8
#endif
#ifndef LIFTREG_PROJ_MIN_BLOCKS
#define LIFTREG_PROJ_MIN_BLOCKS 3
#endif
constexpr int kWarps = LIFTREG_PROJ_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = LIFTREG_PROJ_MIN_BLOCKS;  // blocks per SM
constexpr int kSlots = 2 * kTI;       // S rows
constexpr int kRowsPerWarp = kTI / kWarps;
constexpr int kSlotsPerWarp = kSlots / kWarps;
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

// one plane's taps as a thread holds them: lanes 0..15 the x taps of their
// tile row, every lane those of its column, and the tile's row range
struct Geom {
  int mx0;
  float wx0, wx1;
  int lo, nslots;
  bool contiguous, skip;
  int c0, c1;  // the column taps, clamped (a dropped one has weight 0)
  float wz0, wz1;
};

// the per-plane data that a block shares: its tile's coordinates, and the
// row range and skip flag of each plane, computed once in the prologue
struct PlaneTable {
  float x[kMaxPlanes][kTI];  // rows past RD repeat the last valid row
  float z[kMaxPlanes][kTJ];  // columns past RH repeat the last valid column
  int lo[kMaxPlanes], hi[kMaxPlanes], skip[kMaxPlanes];
};

__device__ __forceinline__ Geom geometry(const PlaneTable& tab, int kk,
                                         int lane, bool jvalid, int D,
                                         int H) {
  Geom g;
  const float xp = tab.x[kk][lane & (kTI - 1)];
  g.mx0 = floor_tap(xp, D);
  g.wx0 = (g.mx0 >= 0 && g.mx0 < D) ? tap_weight(xp, g.mx0) : 0.f;
  g.wx1 = (g.mx0 + 1 >= 0 && g.mx0 + 1 < D) ? tap_weight(xp, g.mx0 + 1)
                                            : 0.f;
  g.lo = tab.lo[kk];
  const int hi = tab.hi[kk];
  g.contiguous = hi - g.lo + 2 <= kSlots;
  g.nslots = g.contiguous ? hi - g.lo + 2 : kSlots;
  g.skip = tab.skip[kk];
  const float zp = tab.z[kk][lane];
  const int mz0 = floor_tap(zp, H);
  g.wz0 = (jvalid && mz0 >= 0 && mz0 < H) ? tap_weight(zp, mz0) : 0.f;
  g.wz1 = (jvalid && mz0 + 1 >= 0 && mz0 + 1 < H) ? tap_weight(zp, mz0 + 1)
                                                  : 0.f;
  g.c0 = min(max(mz0, 0), H - 1);
  g.c1 = min(max(mz0 + 1, 0), H - 1);
  return g;
}

// the volume row of slot s (warp-uniform)
__device__ __forceinline__ int slot_row(const Geom& g, int s) {
  return g.contiguous ? g.lo + s : __shfl_sync(kFull, g.mx0, s >> 1) + (s & 1);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
drr_project_tiles(const float* __restrict__ vol,
                  const float* __restrict__ x_pix,
                  const float* __restrict__ z_pix,
                  const float* __restrict__ dx, float* __restrict__ out,
                  int B, int P, int D, int W, int H, int RD, int RH,
                  int bchunks, int kper, int final_pass) {
  __shared__ float S[kNB][kSlots][kTJ];
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

  // a missing batch element repeats the last one (its sums are not stored)
  int bstart[kNB];
#pragma unroll
  for (int bb = 0; bb < kNB; ++bb) bstart[bb] = min(b0 + bb, B - 1);

  float acc[kRowsPerWarp][kNB];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int bb = 0; bb < kNB; ++bb) acc[r][bb] = 0.f;

  // the z pass of one plane in two halves: all of a warp's loads first (a
  // row outside the volume reads a clamped row), then, once the block is
  // done with S, the interpolated values into S
  float ta[kSlotsPerWarp][kNB], tc[kSlotsPerWarp][kNB];
  auto load_slots = [&](const Geom& g, int k) {
#pragma unroll
    for (int q = 0; q < kSlotsPerWarp; ++q) {
      const int s = warp + kWarps * q;
      if (s >= g.nslots) continue;
      const int rc = min(max(slot_row(g, s), 0), D - 1);
#pragma unroll
      for (int bb = 0; bb < kNB; ++bb) {
        const float* line = vol + ((bstart[bb] * D + rc) * W + k) * H;
        ta[q][bb] = __ldg(line + g.c0);
        tc[q][bb] = __ldg(line + g.c1);
      }
    }
  };
  auto store_slots = [&](const Geom& g) {
#pragma unroll
    for (int q = 0; q < kSlotsPerWarp; ++q) {
      const int s = warp + kWarps * q;
      if (s >= g.nslots) continue;
      const int row = slot_row(g, s);
      const bool rok = row >= 0 && row < D;
#pragma unroll
      for (int bb = 0; bb < kNB; ++bb)
        S[bb][s][lane] = rok ? fmaf(g.wz1, tc[q][bb], g.wz0 * ta[q][bb]) : 0.f;
    }
  };

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

  if (np > 0) {
    Geom cur = geometry(tab, 0, lane, jvalid, D, H);
    if (!cur.skip) {
      load_slots(cur, k_begin);
      store_slots(cur);
    }
    __syncthreads();

    for (int k = k_begin; k < k_end; ++k) {
      // plane k+1: its loads are in flight while plane k's x pass runs
      const bool has_next = k + 1 < k_end;
      const Geom nxt =
          geometry(tab, has_next ? k + 1 - k_begin : 0, lane, jvalid, D, H);
      const bool load_next = has_next && !nxt.skip;
      if (load_next) load_slots(nxt, k + 1);

      // each output row of plane k interpolates S along x
      if (!cur.skip) {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int il = warp + kWarps * r;
          const int m0 = __shfl_sync(kFull, cur.mx0, il);
          const float w0 = __shfl_sync(kFull, cur.wx0, il);
          const float w1 = __shfl_sync(kFull, cur.wx1, il);
          if (i0 + il >= RD) continue;
          const float* slot =
              &S[0][cur.contiguous ? m0 - cur.lo : 2 * il][lane];
#pragma unroll
          for (int bb = 0; bb < kNB; ++bb) {
            acc[r][bb] = fmaf(w0, slot[bb * kSlots * kTJ], acc[r][bb]);
            acc[r][bb] = fmaf(w1, slot[bb * kSlots * kTJ + kTJ], acc[r][bb]);
          }
        }
      }
      __syncthreads();  // S is free
      if (load_next) store_slots(nxt);
      __syncthreads();  // S holds plane k+1
      cur = nxt;
    }
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
