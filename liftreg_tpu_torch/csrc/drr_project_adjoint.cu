// Adjoint of the DRR projector on Hopper: the VJP with respect to the volume
// of out = 0.1 * dx * sum_k Rx[p,k] @ vol[b, :, k, :] @ Rz[p,k]^T
// (csrc/drr_project.cu), from the same per-plane pixel coordinates:
//   dvol[b,d,k,h] = sum_p sum_i Rx[p,k,i,d] * sum_j Rz[p,k,j,h] * G[b,p,i,j],
//   G = (g * 0.1) * dx,
// G rounded in the order in which autodiff of `total * dx * 0.1` makes it.
//
// Replaces the projector's gradient in the JAX package: XLA's autodiff of
// liftreg_tpu/ops/drr.py:project_with_mats (:184-218), the einsum chain that
// liftreg_tpu/ops/pallas_drr.py:_proj_kernel runs forward only. The weights
// are those of liftreg_tpu/ops/drr.py:_two_tap_matrix, max(0, 1 - |pix - m|):
// a tap lies exactly where that is nonzero.
//
// Bound: bytes. At the serving shape (B=4, P=4, 160^3, 240^2) the function
// must write the 65.5 MB dvol and read the 3.7 MB cotangent and the 2.5 MB
// of geometry: ~0.021 ms at 3.35 TB/s. It needs ~4 f32 operations per
// (voxel, view, tap pair), about 1 GFLOP (~0.015 ms at 67 TFLOP/s). The
// cotangent is small (it stays in the 50 MB L2) and every plane reads it:
// what costs is moving it to the SMs, again for every voxel, and finding
// which pixels reach which voxel.
//
// Design:
// - A plan, once per geometry (adjoint_plan_rows, its own entry point):
//   for each geometry row (p, k) of x_pix and z_pix and each voxel index
//   m, the run of pixels whose tap reaches m, (start, count), found by
//   binary search on |fl(pix - m)| < 1 in a row that rises or falls (every
//   row that poses make); kPlanEmpty where no tap reaches m, and
//   kPlanUnordered for every m of a row in no order. The refiner builds it
//   once per call and passes it to its 31 adjoints.
// - Output tiles over a chunk of planes. A block owns kTD rows d x 32
//   columns h (a lane each) over kNK consecutive planes k, for up to 4 batch
//   elements (one float4). Its warps split into kKG plane slots of kTD/kR
//   warps; a thread owns kR consecutive rows d of its column.
// - The cotangent staged once per block and view group, scaled on the way
//   in. The plan's runs of the tile's rows and columns over the chunk give
//   each view's pixel footprint (~28 x 48 pixels at the serving shape for
//   16 x 32 voxels over 8 planes: neighbouring pixels are 0.71-0.99 voxels
//   apart); its G = (g * 0.1) * dx, 4 batch elements a float4, and its
//   coordinates go to dynamic shared memory, and all kNK planes read them.
//   kV views are staged at once; more views take several groups, each
//   later group adding onto the values the same threads stored before.
//   The staging reads 4 bytes a load, coalesced along j across a warp: a
//   stage float4 holds one pixel's 4 batch elements, which lie P*RD*RH
//   floats apart in g. 16-byte loads along j (4 pixels a thread, then a
//   transpose in registers) and a TMA tile (its box is fixed when the
//   tensor map is encoded; each block's footprint has its own size) were
//   not tried: cp.async with every copy in flight was not faster, and the
//   kernel without its staging loads takes 95% of its time (PERF.md).
// - The sums from shared memory, separable and in registers. Per (plane,
//   view) a thread takes its column's kRun z taps (the plan's start; the
//   weights from the staged coordinates), and for each pixel row i of the
//   hull of its kR rows' runs (at most kQ) interpolates G along j at its
//   column once, then adds that value with each row's x weight: about 4
//   float4 reads a (voxel, view) at the serving shape, not 9.
// - Each output is written by one thread, its sum in a fixed order (views
//   ascending, then pixel rows, then columns): no float atomics, the same
//   bits in every run.
// - A general path in the same kernel, for a block and view group whose
//   rows are in no order, whose column runs exceed kRun, whose row hulls
//   exceed kQ or whose footprint does not fit the stage: a thread per voxel
//   sums the runs (whole rows for a row in no order) from global memory.
//   It gives the same function; each such (block, group) adds one to
//   general_tiles when the caller passes a counter.
// On the H100 this takes ~0.12 ms at the serving shape, 17% of its bound:
// tools/torch_drr_sweep.py's ablations leave ~0.06 ms without the sums (the
// prologue, the staging's index arithmetic, the barriers, the stores) and
// ~0.107 without the shared-memory bank conflicts of the sums' float4 reads
// (neighbouring columns read pixels ~1.2 apart, so a quarter warp spans
// more than 8 float4s). Instructions, not bytes, hold it (PERF.md).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

// Compile-time knobs for tools/torch_drr_sweep.py, which times other
// settings (PERF.md). kTD must be a multiple of kR.
#ifndef LIFTREG_ADJ_TD
#define LIFTREG_ADJ_TD 16
#endif
#ifndef LIFTREG_ADJ_ROWS
#define LIFTREG_ADJ_ROWS 4
#endif
#ifndef LIFTREG_ADJ_NK
#define LIFTREG_ADJ_NK 8
#endif
#ifndef LIFTREG_ADJ_KG
#define LIFTREG_ADJ_KG 2
#endif
#ifndef LIFTREG_ADJ_VIEWS
#define LIFTREG_ADJ_VIEWS 4
#endif
#ifndef LIFTREG_ADJ_STAGE_FLOATS
#define LIFTREG_ADJ_STAGE_FLOATS 25600
#endif
#ifndef LIFTREG_ADJ_STAGE_BATCH
#define LIFTREG_ADJ_STAGE_BATCH 12
#endif
#ifndef LIFTREG_ADJ_MIN_BLOCKS
#define LIFTREG_ADJ_MIN_BLOCKS 2
#endif

namespace {

constexpr int kTD = LIFTREG_ADJ_TD;      // tile rows d
constexpr int kTH = 32;                  // tile columns h, one per lane
constexpr int kR = LIFTREG_ADJ_ROWS;     // consecutive rows d per thread
constexpr int kRG = kTD / kR;            // row groups: warps per plane slot
constexpr int kNK = LIFTREG_ADJ_NK;      // planes per block
constexpr int kKG = LIFTREG_ADJ_KG;      // plane slots
constexpr int kThreads = 32 * kRG * kKG;
constexpr int kV = LIFTREG_ADJ_VIEWS;    // views staged at once
constexpr int kStage = LIFTREG_ADJ_STAGE_FLOATS;  // dynamic shared floats
constexpr int kSB = LIFTREG_ADJ_STAGE_BATCH;      // staged values a load batch
constexpr int kNB = 4;                   // batch elements per block
constexpr int kRun = 3;                  // z taps per column, fast path
constexpr int kQ = 2 * kR + 1;           // pixel rows per row group, fast path
constexpr unsigned kFull = 0xffffffffu;
// the prologue's loads a thread: row groups', and columns' runs
constexpr int kXIter = (kV * kNK * kRG + kThreads - 1) / kThreads;
constexpr int kZIter = (kV * kNK * kTH + kThreads - 1) / kThreads;
constexpr int kPlanEmpty = -1;
constexpr int kPlanUnordered = -2;
static_assert(kTD % kR == 0, "a thread's rows must divide the tile's");
static_assert(kThreads <= 1024, "too many threads");
static_assert(kV <= kThreads / 32, "a warp per staged view");
static_assert(kStage % 4 == 0, "the stage holds float4s");
static_assert(kStage < (1 << 22), "div_floor's range");

__device__ __forceinline__ float tap_weight(float pix, float m) {
  return fmaxf(0.f, 1.f - fabsf(pix - m));
}

// floor(a / n) for 0 <= a < 2^22, from r = 1/n rounded: (a + 0.5) / n lies
// at least 0.5 / n from an integer, and the product errs by ~2^-23 of itself
__device__ __forceinline__ int div_floor(int a, float r) {
  return __float2int_rz(__fmul_rn(static_cast<float>(a) + 0.5f, r));
}

// G as autodiff of `total * dx * 0.1` rounds it
__device__ __forceinline__ float scaled(float g, float dx) {
  return __fmul_rn(__fmul_rn(g, 0.1f), dx);
}

// One block a geometry row: rows < `rows` are x_pix's (P*W rows of RD
// pixels, voxel indices m < D), the others z_pix's (RH pixels, m < H).
// plan[row][m] for row (p, k): x at [0, D), z at [D, D + H).
__global__ void adjoint_plan_rows(const float* __restrict__ x_pix,
                                  const float* __restrict__ z_pix,
                                  int2* __restrict__ plan, int rows, int D,
                                  int H, int RD, int RH) {
  const bool is_x = static_cast<int>(blockIdx.x) < rows;
  const int row = is_x ? blockIdx.x : blockIdx.x - rows;
  const int n = is_x ? RD : RH;
  const int nm = is_x ? D : H;
  const float* c = is_x ? x_pix + static_cast<int64_t>(row) * RD
                        : z_pix + static_cast<int64_t>(row) * RH;
  int2* out = plan + static_cast<int64_t>(row) * (D + H) + (is_x ? 0 : D);
  int rising = 1, falling = 1;  // a NaN makes the row neither
  for (int i = threadIdx.x; i + 1 < n; i += blockDim.x) {
    const float a = __ldg(c + i), b = __ldg(c + i + 1);
    rising = rising && a <= b;
    falling = falling && a >= b;
  }
  rising = __syncthreads_and(rising);
  falling = __syncthreads_and(falling);
  const float sgn = rising ? 1.f : -1.f;  // a constant row counts as rising
  for (int m = threadIdx.x; m < nm; m += blockDim.x) {
    if (!rising && !falling) {
      out[m] = make_int2(kPlanUnordered, 0);
      continue;
    }
    // u = sgn * (pix - m) rises with i: the run starts at the first
    // u > -1 and ends at the first u >= 1
    const float fm = static_cast<float>(m);
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (sgn * (__ldg(c + mid) - fm) > -1.f) hi = mid; else lo = mid + 1;
    }
    const int start = lo;
    hi = n;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (sgn * (__ldg(c + mid) - fm) >= 1.f) hi = mid; else lo = mid + 1;
    }
    out[m] = lo > start ? make_int2(start, lo - start)
                        : make_int2(kPlanEmpty, 0);
  }
}

struct Views {
  int ilo[kV], ihi[kV], jlo[kV], jhi[kV], ni[kV], nj[kV];
  float rni[kV], rnj[kV];  // 1 / ni, 1 / nj
  int off[kV];  // float offset of the view's stage region; -1: no taps
  int ccum[kV + 1], gcum[kV + 1];  // staged coordinates and G before view v
  int general;
};

__global__ void __launch_bounds__(kThreads, LIFTREG_ADJ_MIN_BLOCKS)
adjoint_tiles(const float* __restrict__ g, const float* __restrict__ x_pix,
              const float* __restrict__ z_pix, const float* __restrict__ dx,
              const int2* __restrict__ plan, float* __restrict__ dvol,
              int* __restrict__ general_tiles, int B, int P, int D, int W,
              int H, int RD, int RH, int bgroups) {
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  __shared__ int jtab[kV][kNK][kTH];          // column runs' starts
  __shared__ int jlo_k[kV][kNK], jhi_k[kV][kNK];  // per plane: their range
  __shared__ int hlo[kV][kNK][kRG], hhi[kV][kNK][kRG];  // row groups' hulls
  __shared__ Views vw;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp % kRG;
  const int ks = warp / kRG;
  const int h0 = blockIdx.x * kTH;
  const int d0 = blockIdx.y * kTD;
  const int k0 = (blockIdx.z / bgroups) * kNK;
  const int b0 = (blockIdx.z % bgroups) * kNB;
  const int nk = min(kNK, W - k0);
  const int nb = min(kNB, B - b0);
  const int per_view = RD * RH;
  const int plan_row = D + H;
  const int h = h0 + lane;
  const float fh = static_cast<float>(h);
  const int dr = d0 + rg * kR;  // this thread's first row

  for (int p0 = 0; p0 < P; p0 += kV) {
    const int nv = min(kV, P - p0);
    __syncthreads();  // the previous group's stage and tables are read

    // the plan's runs of the tile's rows and columns, all loads issued
    // before any is used: a thread per (view, plane, row group) takes the
    // hull of its kR rows' runs, a warp per (view, plane) its columns' runs
    // (a lane each)
    int2 xrun[kXIter][kR], zrun[kZIter];
#pragma unroll
    for (int it = 0; it < kXIter; ++it) {
      const int e = tid + it * kThreads;
      const int v = e / (kNK * kRG);
      const int kk = (e / kRG) % kNK;
      const int2* pr =
          plan + ((p0 + v) * W + k0 + kk) * plan_row + d0 + (e % kRG) * kR;
#pragma unroll
      for (int r = 0; r < kR; ++r)
        xrun[it][r] = (v < nv && kk < nk && d0 + (e % kRG) * kR + r < D)
                          ? __ldg(pr + r) : make_int2(kPlanEmpty, 0);
    }
#pragma unroll
    for (int it = 0; it < kZIter; ++it) {
      const int e = tid + it * kThreads;
      const int v = e / (kNK * kTH);
      const int kk = (e / kTH) % kNK;
      const int c = e % kTH;
      zrun[it] = (v < nv && kk < nk && h0 + c < H)
                     ? __ldg(plan + ((p0 + v) * W + k0 + kk) * plan_row + D +
                             h0 + c)
                     : make_int2(kPlanEmpty, 0);
    }
    int bad = 0;
#pragma unroll
    for (int it = 0; it < kXIter; ++it) {
      const int e = tid + it * kThreads;
      const int v = e / (kNK * kRG);
      int lo = INT_MAX, hi = -1;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int2 run = xrun[it][r];
        if (run.x == kPlanUnordered) bad = 1;
        if (run.x < 0) continue;
        lo = min(lo, run.x);
        hi = max(hi, run.x + run.y);
      }
      if (hi >= 0 && hi - lo > kQ) bad = 1;
      if (v < nv) {
        hlo[v][(e / kRG) % kNK][e % kRG] = lo;
        hhi[v][(e / kRG) % kNK][e % kRG] = hi;
      }
    }
#pragma unroll
    for (int it = 0; it < kZIter; ++it) {
      const int e = tid + it * kThreads;
      const int v = e / (kNK * kTH);  // the same for the whole warp
      const int kk = (e / kTH) % kNK;
      const int2 run = zrun[it];
      if (run.x == kPlanUnordered || run.y > kRun) bad = 1;
      const int start = max(run.x, kPlanEmpty);
      const int lo = __reduce_min_sync(kFull, start < 0 ? INT_MAX : start);
      const int hi = __reduce_max_sync(kFull, start < 0 ? -1 : start + kRun);
      if (v < nv) {
        jtab[v][kk][e % kTH] = start;
        if (lane == 0) {
          jlo_k[v][kk] = lo;
          jhi_k[v][kk] = hi;
        }
      }
    }
    bad = __syncthreads_or(bad);
    // each view's footprint: a warp per view
    if (!bad && warp < nv) {
      int ilo = INT_MAX, ihi = -1, jlo = INT_MAX, jhi = -1;
      for (int e = lane; e < kNK * kRG; e += 32) {
        ilo = min(ilo, hlo[warp][e / kRG][e % kRG]);
        ihi = max(ihi, hhi[warp][e / kRG][e % kRG]);
      }
      for (int e = lane; e < kNK; e += 32) {
        jlo = min(jlo, jlo_k[warp][e]);
        jhi = max(jhi, jhi_k[warp][e]);
      }
      ilo = __reduce_min_sync(kFull, ilo);
      ihi = __reduce_max_sync(kFull, ihi);
      jlo = __reduce_min_sync(kFull, jlo);
      jhi = __reduce_max_sync(kFull, jhi);
      if (lane == 0) {
        vw.ilo[warp] = ilo;
        vw.ihi[warp] = ihi;
        vw.jlo[warp] = jlo;
        vw.jhi[warp] = jhi;
      }
    }
    __syncthreads();
    if (!bad && tid == 0) {
      // each view's stage region: G (4 floats a pixel), then its x and z
      // coordinates per plane; the cumulative counts of both kinds of
      // staged values, coordinates first
      int off = 0, nc = 0, ng = 0;
      for (int v = 0; v < kV; ++v) {
        vw.ccum[v] = nc;
        vw.gcum[v] = ng;
        if (v >= nv || vw.ihi[v] < 0 || vw.jhi[v] < 0) {
          vw.off[v] = -1;  // no tap of this view reaches the tile
          vw.ni[v] = vw.nj[v] = 0;
          vw.rni[v] = vw.rnj[v] = 0.f;
          continue;
        }
        const int ni = vw.ihi[v] - vw.ilo[v], nj = vw.jhi[v] - vw.jlo[v];
        vw.ni[v] = ni;
        vw.nj[v] = nj;
        vw.rni[v] = 1.f / static_cast<float>(ni);
        vw.rnj[v] = 1.f / static_cast<float>(nj);
        vw.off[v] = off;
        off += (4 * ni * nj + kNK * (ni + nj) + 3) & ~3;
        nc += kNK * (ni + nj);
        ng += ni * nj;
      }
      vw.ccum[kV] = nc;
      vw.gcum[kV] = ng;
      // (div_floor's range: a view's staged values < kStage < 2^22)
      vw.general = off > kStage;
    }
    bad = __syncthreads_or(bad || (tid == 0 && vw.general));

    if (bad) {
      // the general path: a thread per voxel of the tile, these views'
      // runs from global memory
      if (tid == 0 && general_tiles) atomicAdd(general_tiles, 1);
      for (int e = tid; e < kTD * kTH * kNK; e += kThreads) {
        const int c = e % kTH;
        const int r = (e / kTH) % kTD;
        const int kk = e / (kTH * kTD);
        const int d = d0 + r, hh = h0 + c, k = k0 + kk;
        if (d >= D || hh >= H || kk >= nk) continue;
        const float fd = static_cast<float>(d), fhh = static_cast<float>(hh);
        float acc[kNB];
#pragma unroll
        for (int bb = 0; bb < kNB; ++bb)
          acc[bb] = (p0 > 0 && bb < nb)
                        ? dvol[(((b0 + bb) * D + d) * W + k) * H + hh] : 0.f;
        for (int v = 0; v < nv; ++v) {
          const int p = p0 + v;
          const int2* pr = plan + (p * W + k) * plan_row;
          const int2 xr = __ldg(pr + d), zr = __ldg(pr + D + hh);
          if (xr.x == kPlanEmpty || zr.x == kPlanEmpty) continue;
          const int i0 = xr.x == kPlanUnordered ? 0 : xr.x;
          const int i1 = xr.x == kPlanUnordered ? RD : xr.x + xr.y;
          const int j0 = zr.x == kPlanUnordered ? 0 : zr.x;
          const int j1 = zr.x == kPlanUnordered ? RH : zr.x + zr.y;
          const float* xrow = x_pix + (p * W + k) * RD;
          const float* zrow = z_pix + (p * W + k) * RH;
          for (int i = i0; i < i1; ++i) {
            const float wx = tap_weight(__ldg(xrow + i), fd);
            if (wx == 0.f) continue;
            float t[kNB];
#pragma unroll
            for (int bb = 0; bb < kNB; ++bb) t[bb] = 0.f;
            for (int j = j0; j < j1; ++j) {
              const float wz = tap_weight(__ldg(zrow + j), fhh);
              if (wz == 0.f) continue;
              const int pix = i * RH + j;
              const float dv = __ldg(dx + p * per_view + pix);
#pragma unroll
              for (int bb = 0; bb < kNB; ++bb)
                if (bb < nb)
                  t[bb] = fmaf(wz, scaled(__ldg(g + ((b0 + bb) * P + p) *
                                                        per_view + pix), dv),
                               t[bb]);
            }
#pragma unroll
            for (int bb = 0; bb < kNB; ++bb) acc[bb] = fmaf(wx, t[bb], acc[bb]);
          }
        }
#pragma unroll
        for (int bb = 0; bb < kNB; ++bb)
          if (bb < nb) dvol[(((b0 + bb) * D + d) * W + k) * H + hh] = acc[bb];
      }
      continue;
    }

    // stage each view's footprint: its coordinates per plane (past the
    // detector's last column a value whose weight is 0), then G scaled, 4
    // batch elements a float4 (zeros past the last column and the batch).
    // One index over all views and both kinds; a thread issues the loads
    // of kSB values before it stores any.
    const int nc = vw.ccum[kV], ntot = nc + vw.gcum[kV];
    for (int e0 = tid; e0 < ntot; e0 += kThreads * kSB) {
      float gv[kSB][kNB], dv[kSB];
      int dst[kSB];  // float index into the stage; -1: none
#pragma unroll
      for (int q = 0; q < kSB; ++q) {
        const int e = e0 + q * kThreads;
        const bool coord = e < nc;
        const int* cum = coord ? vw.ccum : vw.gcum;
        const int ev = coord ? e : e - nc;
        int v = 0;
#pragma unroll
        for (int u = 1; u < kV; ++u) v += ev >= cum[u];
        const int el = ev - cum[v];
        const int p = p0 + v;
        const int ni = vw.ni[v], nj = vw.nj[v];
        const int ilo = vw.ilo[v], jlo = vw.jlo[v];
        dv[q] = 0.f;
#pragma unroll
        for (int bb = 0; bb < kNB; ++bb) gv[q][bb] = 0.f;
        dst[q] = e < ntot ? vw.off[v] + (coord ? 4 * ni * nj + el : 4 * el)
                          : -1;
        if (e >= ntot) continue;
        if (coord && el < kNK * ni) {
          const int kk = div_floor(el, vw.rni[v]);
          if (kk < nk)
            dv[q] = __ldg(x_pix + (p * W + k0 + kk) * RD + ilo + el -
                          kk * ni);
        } else if (coord) {
          const int ec = el - kNK * ni;
          const int kk = div_floor(ec, vw.rnj[v]);
          const int j = jlo + ec - kk * nj;
          dv[q] = (kk < nk && j < RH)
                      ? __ldg(z_pix + (p * W + k0 + kk) * RH + j) : 3.0e38f;
        } else {
          const int ii = div_floor(el, vw.rnj[v]);
          const int j = jlo + el - ii * nj;
          const int pix = (ilo + ii) * RH + j;
          if (j < RH) {
            dv[q] = __ldg(dx + p * per_view + pix);
#pragma unroll
            for (int bb = 0; bb < kNB; ++bb)
              if (bb < nb)
                gv[q][bb] = __ldg(g + ((b0 + bb) * P + p) * per_view + pix);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kSB; ++q) {
        if (dst[q] < 0) continue;
        if (e0 + q * kThreads < nc)
          stage[dst[q]] = dv[q];
        else
          *reinterpret_cast<float4*>(stage + dst[q]) =
              make_float4(scaled(gv[q][0], dv[q]), scaled(gv[q][1], dv[q]),
                          scaled(gv[q][2], dv[q]), scaled(gv[q][3], dv[q]));
      }
    }
    __syncthreads();

    // per plane of this thread's slot: the sums of its kR rows, column h
    for (int kk = ks; kk < nk; kk += kKG) {
      const int k = k0 + kk;
      float acc[kR][kNB];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int bb = 0; bb < kNB; ++bb)
          acc[r][bb] = (p0 > 0 && bb < nb && dr + r < D && h < H)
                           ? dvol[(((b0 + bb) * D + dr + r) * W + k) * H + h]
                           : 0.f;
      for (int v = 0; v < nv; ++v) {
        const int off = vw.off[v];
        const int lo = hlo[v][kk][rg], hi = hhi[v][kk][rg];
        if (off < 0 || hi < 0) continue;  // the same for the whole warp
        const int ilo = vw.ilo[v], jlo = vw.jlo[v];
        const int ni = vw.ni[v], nj = vw.nj[v];
        const float* xc = stage + off + 4 * ni * nj + kk * ni;
        const float* zc = stage + off + 4 * ni * nj + kNK * ni + kk * nj;
        const int jst = jtab[v][kk][lane];
        // a column that no tap reaches reads valid columns, all of weight 0
        const int js = jst < 0 ? 0 : jst - jlo;
        float wz[kRun];
#pragma unroll
        for (int b = 0; b < kRun; ++b) wz[b] = tap_weight(zc[js + b], fh);
        const float4* S =
            reinterpret_cast<const float4*>(stage + off) + js;
        const int u0 = lo - ilo, nq = hi - lo;
        // lanes whose run has two taps make no shared-memory request for
        // the third
        const bool tap2 = wz[2] != 0.f;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          if (q >= nq) break;
          // pixel row u0 + q: its x coordinate and the 3 taps of G at js
          const float xq = xc[u0 + q];
          const float4* row = S + (u0 + q) * nj;
          const float4 a = row[0], b = row[1];
          const float4 c = tap2 ? row[2] : make_float4(0.f, 0.f, 0.f, 0.f);
          const float t[kNB] = {
              fmaf(wz[2], c.x, fmaf(wz[1], b.x, wz[0] * a.x)),
              fmaf(wz[2], c.y, fmaf(wz[1], b.y, wz[0] * a.y)),
              fmaf(wz[2], c.z, fmaf(wz[1], b.z, wz[0] * a.z)),
              fmaf(wz[2], c.w, fmaf(wz[1], b.w, wz[0] * a.w))};
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float wx = tap_weight(xq, static_cast<float>(dr + r));
#pragma unroll
            for (int bb = 0; bb < kNB; ++bb)
              acc[r][bb] = fmaf(wx, t[bb], acc[r][bb]);
          }
        }
      }
      if (h >= H) continue;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (dr + r >= D) break;
#pragma unroll
        for (int bb = 0; bb < kNB; ++bb)
          if (bb < nb)
            dvol[(((b0 + bb) * D + dr + r) * W + k) * H + h] = acc[r][bb];
      }
    }
  }
}

}  // namespace

// The adjoint's plan of a geometry: plan (P, W, D + H) int2 from x_pix
// (P, W, RD) and z_pix (P, W, RH), f32 and contiguous; every index below
// 2^31 (the wrapper checks). Launches on `stream` without synchronising;
// returns cudaGetLastError().
extern "C" int liftreg_drr_adjoint_plan(const float* x_pix,
                                        const float* z_pix, int* plan,
                                        int64_t P, int64_t W, int64_t D,
                                        int64_t H, int64_t RD, int64_t RH,
                                        void* stream) {
  const int64_t rows = P * W;
  if (rows * (D + H) == 0) return static_cast<int>(cudaSuccess);
  adjoint_plan_rows<<<static_cast<unsigned>(2 * rows), 128, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x_pix, z_pix, reinterpret_cast<int2*>(plan), static_cast<int>(rows),
      static_cast<int>(D), static_cast<int>(H), static_cast<int>(RD),
      static_cast<int>(RH));
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream` without synchronising; returns the first CUDA error.
// g (B, P, RD, RH), x_pix (P, W, RD), z_pix (P, W, RH), dx (P, RD, RH),
// plan (P, W, D + H) int2 from liftreg_drr_adjoint_plan on this geometry,
// dvol (B, D, W, H); all contiguous, every index below 2^31 (the wrapper
// checks). general_tiles, if not null, gains one for each (block, view
// group) that takes the general path.
extern "C" int liftreg_drr_project_adjoint(
    const float* g, const float* x_pix, const float* z_pix, const float* dx,
    const int* plan, float* dvol, int* general_tiles, int64_t B, int64_t P,
    int64_t D, int64_t W, int64_t H, int64_t RD, int64_t RH, void* stream) {
  if (B * D * W * H == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P * RD * RH == 0)
    return static_cast<int>(
        cudaMemsetAsync(dvol, 0, B * D * W * H * sizeof(float), s));
  const int64_t bgroups = (B + kNB - 1) / kNB;
  const int64_t kchunks = (W + kNK - 1) / kNK;
  if (kchunks * bgroups > 65535 || (D + kTD - 1) / kTD > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int smem = kStage * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      adjoint_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((H + kTH - 1) / kTH),
                  static_cast<unsigned>((D + kTD - 1) / kTD),
                  static_cast<unsigned>(kchunks * bgroups));
  adjoint_tiles<<<grid, kThreads, smem, s>>>(
      g, x_pix, z_pix, dx, reinterpret_cast<const int2*>(plan), dvol,
      general_tiles, static_cast<int>(B), static_cast<int>(P),
      static_cast<int>(D), static_cast<int>(W), static_cast<int>(H),
      static_cast<int>(RD), static_cast<int>(RH),
      static_cast<int>(bgroups));
  return static_cast<int>(cudaGetLastError());
}
