// Variant of liftreg_tpu_torch/csrc/drr_project.cu for
// tools/torch_drr_sweep.py: each plane's volume footprint is staged into
// shared memory with cp.async, double-buffered over the planes, so that
// plane k+1's loads are in flight while plane k is interpolated. It has the
// same entry point and computes the same values, bit for bit: the z pass
// reads the staged slab instead of the volume, with the same clamped
// indices.
//
// Per plane, the tile's rows read volume rows lo..hi+1 and its columns
// volume columns zlo..zhi+1 (both runs increase with the detector index);
// when that rectangle fits the slab (kSlabRows x kSlabCols, for all kNB
// volumes), it is copied with 4-byte cp.async (its column start is not
// aligned), one commit group per plane. A plane whose footprint does not
// fit loads directly, as the kernel in csrc/ does. Loop per plane: issue
// the next staged plane's copies into the other buffer, wait for this
// plane's group, barrier, z pass (slab -> S), barrier, x pass (S -> the
// accumulators). The slabs make the block need dynamic shared memory
// (~53 KB), so fewer blocks are resident per SM than in csrc/.
#include <cstdint>

#include <cuda_runtime.h>

// Compile-time knobs, as in csrc/, plus the slab's size. The tile's rows
// must be a power of two <= 32 and a multiple of the warps.
#ifndef LIFTREG_PROJ_TI
#define LIFTREG_PROJ_TI 16
#endif
#ifndef LIFTREG_PROJ_WARPS
#define LIFTREG_PROJ_WARPS 4
#endif
#ifndef LIFTREG_PROJ_SLAB_ROWS
#define LIFTREG_PROJ_SLAB_ROWS 20
#endif
#ifndef LIFTREG_PROJ_SLAB_COLS
#define LIFTREG_PROJ_SLAB_COLS 36
#endif

namespace {

constexpr int kTI = LIFTREG_PROJ_TI;   // tile rows (detector i), <= 32
constexpr int kTJ = 32;               // tile columns (detector j), one per lane
constexpr int kNB = 4;                // batch elements per block
constexpr int kWarps = LIFTREG_PROJ_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 2 * kTI;       // S rows
constexpr int kRowsPerWarp = kTI / kWarps;
constexpr int kMaxPlanes = 64;        // planes per block (the wrapper splits)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlabRows = LIFTREG_PROJ_SLAB_ROWS;
constexpr int kSlabCols = LIFTREG_PROJ_SLAB_COLS;
constexpr int kSlab = kNB * kSlabRows * kSlabCols;  // floats per buffer

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

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
  int cb[kMaxPlanes], fit[kMaxPlanes];  // slab's first column; it fits
};

__global__ void __launch_bounds__(kThreads)
drr_project_tiles(const float* __restrict__ vol,
                  const float* __restrict__ x_pix,
                  const float* __restrict__ z_pix,
                  const float* __restrict__ dx, float* __restrict__ out,
                  int B, int P, int D, int W, int H, int RD, int RH,
                  int bchunks, int kper, int final_pass) {
  extern __shared__ float smem[];
  float(*S)[kSlots][kTJ] = reinterpret_cast<float(*)[kSlots][kTJ]>(smem);
  PlaneTable& tab =
      *reinterpret_cast<PlaneTable*>(smem + kNB * kSlots * kTJ);
  float* slabs = smem + kNB * kSlots * kTJ +
                 (sizeof(PlaneTable) + sizeof(float) - 1) / sizeof(float);
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
    const int zlo = __reduce_min_sync(kFull, mz0);
    const int zhi = __reduce_max_sync(kFull, mz0);
    if (lane == 0) {
      tab.lo[kk] = lo;
      tab.hi[kk] = hi;
      tab.cb[kk] = zlo;
      tab.fit[kk] = hi - lo + 2 <= kSlabRows && zhi - zlo + 2 <= kSlabCols;
      // a plane whose taps all miss the volume adds exactly nothing
      tab.skip[kk] = hi + 1 < 0 || lo > D - 1 || !any_col;
    }
  }
  __syncthreads();

  // plane kk's footprint into slab buffer `buf`, for every batch element
  // (a row or column outside the volume copies a clamped one)
  auto issue = [&](int kk, int buf) {
    const int k = k_begin + kk;
    const int lo = tab.lo[kk], cb = tab.cb[kk];
    const int nrows = tab.hi[kk] - lo + 2;
    float* dst = slabs + buf * kSlab;
#pragma unroll
    for (int bb = 0; bb < kNB; ++bb)
      for (int s = warp; s < nrows; s += kWarps) {
        const int rc = min(max(lo + s, 0), D - 1);
        const float* line = vol + ((bstart[bb] * D + rc) * W + k) * H;
        for (int c = lane; c < kSlabCols; c += 32)
          cp_async4(dst + (bb * kSlabRows + s) * kSlabCols + c,
                    line + min(max(cb + c, 0), H - 1));
      }
  };
  // the next plane after kk that is not skipped (it is staged if it fits)
  auto next_plane = [&](int kk) {
    ++kk;
    while (kk < np && tab.skip[kk]) ++kk;
    return kk;
  };

  int kk = next_plane(-1);
  int buf = 0;
  if (kk < np && tab.fit[kk]) issue(kk, buf);
  cp_async_commit();
  while (kk < np) {
    const int kn = next_plane(kk);
    if (kn < np && tab.fit[kn]) issue(kn, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();  // this thread's copies of plane kk
    __syncthreads();       // everyone's copies; S is free
    const int k = k_begin + kk;
    // x taps of the tile's rows (lanes 0..15) and their row range
    const float xp = tab.x[kk][lane & (kTI - 1)];
    const int mx0 = floor_tap(xp, D);
    const float wx0 = (mx0 >= 0 && mx0 < D) ? tap_weight(xp, mx0) : 0.f;
    const float wx1 = (mx0 + 1 >= 0 && mx0 + 1 < D) ? tap_weight(xp, mx0 + 1)
                                                    : 0.f;
    const int lo = tab.lo[kk];
    const int hi = tab.hi[kk];
    const bool contiguous = hi - lo + 2 <= kSlots;
    const int nslots = contiguous ? hi - lo + 2 : kSlots;

    const float zp = tab.z[kk][lane];
    const int mz0 = floor_tap(zp, H);
    const float wz0 = (jvalid && mz0 >= 0 && mz0 < H) ? tap_weight(zp, mz0)
                                                      : 0.f;
    const float wz1 = (jvalid && mz0 + 1 >= 0 && mz0 + 1 < H)
                          ? tap_weight(zp, mz0 + 1) : 0.f;
    if (tab.fit[kk]) {
      // the z pass from the slab: the same clamped values as the volume's
      const float* sl = slabs + buf * kSlab + (mz0 - tab.cb[kk]);
      for (int s = warp; s < nslots; s += kWarps) {
        const int row = lo + s;
        const bool rok = row >= 0 && row < D;
#pragma unroll
        for (int bb = 0; bb < kNB; ++bb) {
          const float* v = sl + (bb * kSlabRows + s) * kSlabCols;
          S[bb][s][lane] = rok ? fmaf(wz1, v[1], wz0 * v[0]) : 0.f;
        }
      }
    } else {
      const float* col0 = vol + k * H + min(max(mz0, 0), H - 1);
      const float* col1 = vol + k * H + min(max(mz0 + 1, 0), H - 1);
      for (int s = warp; s < nslots; s += kWarps) {
        const int row = contiguous ? lo + s
                                   : __shfl_sync(kFull, mx0, (s >> 1) & 31) +
                                         (s & 1);
        const int rc = min(max(row, 0), D - 1);
        const bool rok = row >= 0 && row < D;
        float a[kNB], c[kNB];
#pragma unroll
        for (int bb = 0; bb < kNB; ++bb) {
          const int o = (bstart[bb] * D + rc) * W * H;
          a[bb] = __ldg(col0 + o);
          c[bb] = __ldg(col1 + o);
        }
#pragma unroll
        for (int bb = 0; bb < kNB; ++bb)
          S[bb][s][lane] = rok ? fmaf(wz1, c[bb], wz0 * a[bb]) : 0.f;
      }
    }
    __syncthreads();

    // each output row interpolates S along x
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int il = warp + kWarps * r;
      const int m0 = __shfl_sync(kFull, mx0, il);
      const float w0 = __shfl_sync(kFull, wx0, il);
      const float w1 = __shfl_sync(kFull, wx1, il);
      if (i0 + il >= RD) continue;
      const float* slot = &S[0][contiguous ? m0 - lo : 2 * il][lane];
#pragma unroll
      for (int bb = 0; bb < kNB; ++bb) {
        acc[r][bb] = fmaf(w0, slot[bb * kSlots * kTJ], acc[r][bb]);
        acc[r][bb] = fmaf(w1, slot[bb * kSlots * kTJ + kTJ], acc[r][bb]);
      }
    }
    kk = kn;
    buf ^= 1;
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
  const int smem = static_cast<int>(
      sizeof(float) * (kNB * kSlots * kTJ + 2 * kSlab) +
      (sizeof(PlaneTable) + sizeof(float) - 1) / sizeof(float) *
          sizeof(float));
  cudaFuncSetAttribute(drr_project_tiles,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  drr_project_tiles<<<grid, kThreads, smem, s>>>(
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
