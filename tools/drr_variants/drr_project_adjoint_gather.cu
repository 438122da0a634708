// Variant of liftreg_tpu_torch/csrc/drr_project_adjoint.cu for
// tools/torch_drr_sweep.py: the first design of the projector's adjoint,
// kept so that the sweep times it beside the staged design on one card.
// It computes the same function from the geometry alone (no plan), with its
// own entry point, liftreg_drr_project_adjoint_gather, and scratch for the
// scaled cotangent and the rows' order:
//   dvol[b,d,k,h] = sum_p sum_i Rx[p,k,i,d] * sum_j Rz[p,k,j,h] * G[b,p,i,j],
//   G = (g * 0.1) * dx.
//
// Design (three passes):
// - Pass 1 scales the cotangent once into scratch, G = (g * 0.1) * dx.
// - Pass 2 marks each row (p, k) of x_pix and z_pix as non-decreasing,
//   non-increasing or neither.
// - Pass 3 gathers: a thread owns the voxel column h of row d of plane k for
//   up to kNB batch elements (a warp is one row d, its lanes 32 columns; the
//   block 8 rows). In a monotone row the pixels whose tap reaches voxel m are
//   the contiguous run where |fl(pix - m)| < 1; a binary search in global
//   memory finds it. The runs of the block's 32 columns go to shared memory
//   once per view; the run of a row d is found by the lane of that view and
//   broadcast by a shuffle. A row in no order takes the whole row as its
//   run. Per view the thread interpolates G along j at its column for each
//   pixel row i of the run, then along i.
// - Every output is written once by one thread, in a fixed order: no float
//   atomics, the same bits in every run.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kNB = 4;           // batch elements per thread
constexpr int kRows = 8;         // warps per block, one row d each
constexpr int kViewChunk = 32;   // views whose runs the block holds at once
constexpr unsigned kFull = 0xffffffffu;

enum RowOrder { kNone = 0, kRising = 1, kFalling = 2 };

__device__ __forceinline__ float tap_weight(float pix, int m) {
  return fmaxf(0.f, 1.f - fabsf(pix - static_cast<float>(m)));
}

// G[o] = (g[o] * 0.1) * dx[p, pixel]
__global__ void adjoint_scale(const float* __restrict__ g,
                              const float* __restrict__ dx,
                              float* __restrict__ G, int total, int per_view,
                              int P) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const int pix = o % per_view;
  const int p = (o / per_view) % P;
  G[o] = __fmul_rn(__fmul_rn(g[o], 0.1f), __ldg(dx + p * per_view + pix));
}

// order[r] for the rows of x_pix (r < P*W, length RD) and then of z_pix
// (length RH): kRising, kFalling or kNone (a constant row counts as rising;
// a NaN makes the row kNone). One warp a row.
__global__ void adjoint_row_order(const float* __restrict__ x_pix,
                                  const float* __restrict__ z_pix,
                                  int* __restrict__ order, int rows, int RD,
                                  int RH) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= 2 * rows) return;
  const bool is_x = r < rows;
  const int n = is_x ? RD : RH;
  const float* row = is_x ? x_pix + static_cast<int64_t>(r) * RD
                          : z_pix + static_cast<int64_t>(r - rows) * RH;
  bool rising = true, falling = true;
  for (int i = lane; i + 1 < n; i += 32) {
    const float a = __ldg(row + i), c = __ldg(row + i + 1);
    rising = rising && a <= c;
    falling = falling && a >= c;
  }
  rising = __all_sync(kFull, rising);
  falling = __all_sync(kFull, falling);
  if (lane == 0) order[r] = rising ? kRising : (falling ? kFalling : kNone);
}

// [start, end) of the pixels of `row` (length n, in order `ord`) whose tap
// reaches voxel m: |fl(row[i] - m)| < 1. With u = +-(row[i] - m) rising in
// i, the run starts at the first u > -1 and ends at the first u >= 1.
__device__ __forceinline__ int2 tap_run(const float* __restrict__ row, int n,
                                        int ord, int m) {
  if (ord == kNone) return make_int2(0, n);
  const float sgn = ord == kRising ? 1.f : -1.f;
  const float fm = static_cast<float>(m);
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sgn * (__ldg(row + mid) - fm) > -1.f) hi = mid; else lo = mid + 1;
  }
  const int start = lo;
  hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sgn * (__ldg(row + mid) - fm) >= 1.f) hi = mid; else lo = mid + 1;
  }
  return make_int2(start, lo);
}

__global__ void __launch_bounds__(32 * kRows)
adjoint_gather(const float* __restrict__ G, const float* __restrict__ x_pix,
               const float* __restrict__ z_pix, const int* __restrict__ order,
               float* __restrict__ dvol, int B, int P, int D, int W, int H,
               int RD, int RH) {
  __shared__ int2 jrun[kViewChunk][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = blockIdx.x * 32 + lane;
  const int d = blockIdx.y * kRows + warp;
  const int k = blockIdx.z % W;
  const int b0 = (blockIdx.z / W) * kNB;
  const int nb = min(kNB, B - b0);
  const bool hvalid = h < H;
  const bool valid = hvalid && d < D;
  const int hc = min(h, H - 1);
  const int per_view = RD * RH;

  float acc[kNB];
#pragma unroll
  for (int bb = 0; bb < kNB; ++bb) acc[bb] = 0.f;

  for (int p0 = 0; p0 < P; p0 += kViewChunk) {
    const int nv = min(kViewChunk, P - p0);
    __syncthreads();  // the previous chunk's runs are read
    for (int v = warp; v < nv; v += kRows) {
      const int row = (p0 + v) * W + k;
      jrun[v][lane] = tap_run(z_pix + static_cast<int64_t>(row) * RH, RH,
                              order[P * W + row], hc);
    }
    __syncthreads();
    // lane v finds the run of this warp's row d in view p0 + v
    int2 my_irun = make_int2(0, 0);
    if (lane < nv && d < D) {
      const int row = (p0 + lane) * W + k;
      my_irun = tap_run(x_pix + static_cast<int64_t>(row) * RD, RD,
                        order[row], d);
    }
    for (int v = 0; v < nv; ++v) {
      const int i0 = __shfl_sync(kFull, my_irun.x, v);
      const int i1 = __shfl_sync(kFull, my_irun.y, v);
      if (!valid) continue;
      const int p = p0 + v;
      const float* xr = x_pix + (p * W + k) * RD;
      const float* zr = z_pix + (p * W + k) * RH;
      const int2 jr = jrun[v][lane];
      for (int i = i0; i < i1; ++i) {
        const float wx = tap_weight(__ldg(xr + i), d);
        if (wx == 0.f) continue;  // only in a row in no order
        float t[kNB];
#pragma unroll
        for (int bb = 0; bb < kNB; ++bb) t[bb] = 0.f;
        const float* grow = G + (b0 * P + p) * per_view + i * RH;
        for (int j = jr.x; j < jr.y; ++j) {
          const float wz = tap_weight(__ldg(zr + j), h);
#pragma unroll
          for (int bb = 0; bb < kNB; ++bb)
            if (bb < nb) t[bb] = fmaf(wz, __ldg(grow + bb * P * per_view + j),
                                      t[bb]);
        }
#pragma unroll
        for (int bb = 0; bb < kNB; ++bb) acc[bb] = fmaf(wx, t[bb], acc[bb]);
      }
    }
  }
  if (!valid) return;
#pragma unroll
  for (int bb = 0; bb < kNB; ++bb)
    if (bb < nb) dvol[(((b0 + bb) * D + d) * W + k) * H + h] = acc[bb];
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
// g (B, P, RD, RH), x_pix (P, W, RD), z_pix (P, W, RH), dx (P, RD, RH),
// dvol (B, D, W, H); all f32 and contiguous, every index below 2^31 (the
// wrapper checks). Scratch: G holds B * P * RD * RH f32, order 2 * P * W
// ints.
extern "C" int liftreg_drr_project_adjoint_gather(
    const float* g, const float* x_pix, const float* z_pix, const float* dx,
    float* dvol, float* G, int* order, int64_t B, int64_t P, int64_t D,
    int64_t W, int64_t H, int64_t RD, int64_t RH, void* stream) {
  if (B * D * W * H == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P * RD * RH == 0)
    return static_cast<int>(
        cudaMemsetAsync(dvol, 0, B * D * W * H * sizeof(float), s));
  const int total = static_cast<int>(B * P * RD * RH);
  adjoint_scale<<<(total + 255) / 256, 256, 0, s>>>(
      g, dx, G, total, static_cast<int>(RD * RH), static_cast<int>(P));
  const int rows = static_cast<int>(P * W);
  adjoint_row_order<<<(2 * rows + 7) / 8, 256, 0, s>>>(
      x_pix, z_pix, order, rows, static_cast<int>(RD), static_cast<int>(RH));
  const int64_t bgroups = (B + kNB - 1) / kNB;
  if (W * bgroups > 65535 || (D + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>((H + 31) / 32),
                  static_cast<unsigned>((D + kRows - 1) / kRows),
                  static_cast<unsigned>(W * bgroups));
  adjoint_gather<<<grid, 32 * kRows, 0, s>>>(
      G, x_pix, z_pix, order, dvol, static_cast<int>(B), static_cast<int>(P),
      static_cast<int>(D), static_cast<int>(W), static_cast<int>(H),
      static_cast<int>(RD), static_cast<int>(RH));
  return static_cast<int>(cudaGetLastError());
}
