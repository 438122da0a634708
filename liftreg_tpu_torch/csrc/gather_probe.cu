// The gather probes on Hopper: a tile x (M, L) in f32 or bf16 and, where
// the probe gathers, int32 indices idx (M, L); out (M, L) in x's type.
//
// Replaces the five Pallas kernels with which the JAX package measured
// whether a locality warp (its source kept in fast on-chip memory) could
// pay on its TPU (DESIGN.md, "Pallas warp"):
// - kRows:     tools/bench_mosaic_gather.py:94 gather_sub_kernel,
//              out[i,j] = sum_k x[(idx[i,j] + k) mod M, j];
// - kLanes:    tools/bench_mosaic_gather.py:103 gather_lane_kernel,
//              out[i,j] = sum_k x[i, (idx[i,j] + k) mod L];
// - kRoll:     tools/bench_mosaic_gather.py:112 roll_kernel,
//              out[i,j] = sum_k x[i, (j - k - 1) mod L] (np.roll's way);
// - kWarpStep: tools/bench_mosaic_gather.py:120 warp_step_kernel, with
//              w = 0.25 x[i,j]: acc += (idx mod 7 == k mod 7)
//              ? x[(idx + k) mod M, j] * w : 0;
// - tools/repro_mosaic_gather_500.py:41's one take_along_axis is kRows or
//   kLanes at inner = 1.
// The sums run over k = 0 .. inner-1 in order, in f32 with no fused
// multiply-add (__fadd_rn, __fmul_rn), and for bf16 each sum and product
// is rounded to bf16 where the JAX kernel's bf16 arithmetic rounds it. The
// modulo is a floor modulo for any int32, idx + k wrapping in 32 bits as
// XLA's int32 add does. gridDim.y repeats the whole tile (the JAX tool's
// grid): every pass writes the same values to the same output.
//
// Design. Mosaic wanted operand, indices and output of one shape, with the
// gather along sublanes or lanes of one register tile; here the tile is
// staged in shared memory in bands, and the indices stay in registers:
// - Axis 0 (kRows, kWarpStep): an output reads only its own column, so a
//   block stages all M rows of a band of 32 columns (M * 128 B in f32:
//   160 KB at M = 1280) and the 32 lanes of a warp take the band's 32
//   neighbouring columns of one row. Element (r, c) of the band sits in
//   bank c mod 32 (f32) or c/2 (bf16, two lanes a word) whatever row r is
//   gathered, so the arbitrary row gather has no bank conflict.
// - Axis 1 (kLanes, kRoll): an output reads only its own row, so a block
//   stages 8 whole rows, and the lanes of a warp take neighbouring columns
//   of a row. The roll reads neighbouring columns (no conflict); the lane
//   gather reads arbitrary ones, whose bank conflicts are the cost this
//   probe exists to measure, and are left as they are.
// Bound: each gathered element is one shared-memory read (4 B in f32),
// at 128 B a clock an SM: ~33 TB/s over 132 SMs at 1.98 GHz (the card's
// clocks.max.sm gives the clock), or the device-memory bytes of x, idx and
// out at 3.35 TB/s, whichever is larger; at the probes' tiles the first.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Op { kRows = 0, kLanes = 1, kRoll = 2, kWarpStep = 3 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBand = 32;     // columns of an axis-0 band: a warp's lanes
constexpr int kRowBand = 8;   // rows of an axis-1 band
constexpr int kInFlight = 4;  // index loads a thread issues before it gathers
// shared memory a block may use on an H100
constexpr int64_t kMaxSmem = 232448;

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
  // the f32 value rounded to bf16, as a bf16 add or multiply rounds it
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// a mod n, rounded toward -infinity (jnp.remainder), for n > 0
__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// a + k in 32 bits with two's-complement wrap
__device__ __forceinline__ int wrap_add(int a, int k) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(k));
}

// out[r, column] of kRows or kWarpStep from the band (all M rows of the
// block's 32 columns; the thread's column is its lane) and idx[r, column]
template <typename T, int OP>
__device__ __forceinline__ float column_sum(const T* band, int lane, int r,
                                            int i, int M, int inner) {
  float acc = 0.f;
  if constexpr (OP == kRows) {
    for (int k = 0; k < inner; ++k) {
      const int j = floor_mod(wrap_add(i, k), M);
      acc = Num<T>::round(
          __fadd_rn(acc, Num<T>::load(band[j * kBand + lane])));
    }
  } else {
    const float w =
        Num<T>::round(__fmul_rn(Num<T>::load(band[r * kBand + lane]), 0.25f));
    const int phase = floor_mod(i, 7);
    for (int k = 0; k < inner; ++k) {
      const int j = floor_mod(wrap_add(i, k), M);
      const float g = Num<T>::load(band[j * kBand + lane]);
      const float v = phase == k % 7 ? Num<T>::round(__fmul_rn(g, w)) : 0.f;
      acc = Num<T>::round(__fadd_rn(acc, v));
    }
  }
  return acc;
}

// out[r, c] of kLanes or kRoll from row r staged whole (L columns) and
// idx[r, c]
template <typename T, int OP>
__device__ __forceinline__ float row_sum(const T* row, int c, int i, int L,
                                         int inner) {
  float acc = 0.f;
  for (int k = 0; k < inner; ++k) {
    int j;
    if constexpr (OP == kLanes) {
      j = floor_mod(wrap_add(i, k), L);
    } else {
      // roll by s = (k + 1) mod L: column c reads column c - s
      const int s = static_cast<int>((static_cast<int64_t>(k) + 1) % L);
      j = c - s < 0 ? c - s + L : c - s;
    }
    acc = Num<T>::round(__fadd_rn(acc, Num<T>::load(row[j])));
  }
  return acc;
}

// kRows and kWarpStep: block (band, pass) stages rows 0..M-1 of columns
// [32 band, 32 band + 32) and warp w computes rows w, w + 8, ..., loading
// the indices of kInFlight rows before it gathers for any of them
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    probe_columns(const T* __restrict__ x, const int* __restrict__ idx,
                  T* __restrict__ out, int M, int L, int inner) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* band = reinterpret_cast<T*>(smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kBand + lane;
  const bool live = col < L;
#pragma unroll 4
  for (int r = warp; r < M; r += kWarps)
    band[r * kBand + lane] =
        live ? x[static_cast<int64_t>(r) * L + col] : Num<T>::store(0.f);
  __syncthreads();
  if (!live) return;
  for (int r0 = warp; r0 < M; r0 += kInFlight * kWarps) {
    int iv[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int r = r0 + u * kWarps;
      iv[u] = r < M ? idx[static_cast<int64_t>(r) * L + col] : 0;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int r = r0 + u * kWarps;
      if (r < M)
        out[static_cast<int64_t>(r) * L + col] =
            Num<T>::store(column_sum<T, OP>(band, lane, r, iv[u], M, inner));
    }
  }
}

// kLanes and kRoll: block (band, pass) stages rows [8 band, 8 band + 8)
// whole; thread t computes elements t, t + 256, ... of the band, loading
// the indices of kInFlight elements before it gathers for any of them
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    probe_rows(const T* __restrict__ x, const int* __restrict__ idx,
               T* __restrict__ out, int M, int L, int inner) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* rows = reinterpret_cast<T*>(smem);
  const int r0 = blockIdx.x * kRowBand;
  const int n = min(kRowBand, M - r0) * L;
  const int64_t base = static_cast<int64_t>(r0) * L;
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += kThreads) rows[e] = x[base + e];
  __syncthreads();
  for (int e0 = threadIdx.x; e0 < n; e0 += kInFlight * kThreads) {
    int iv[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * kThreads;
      iv[u] = OP == kLanes && e < n ? idx[base + e] : 0;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * kThreads;
      if (e < n) {
        const int r = e / L;
        out[base + e] = Num<T>::store(
            row_sum<T, OP>(rows + r * L, e - r * L, iv[u], L, inner));
      }
    }
  }
}

template <typename T, int OP>
int launch(const void* x, const void* idx, void* out, int M, int L,
           int inner, int passes, cudaStream_t stream) {
  constexpr bool kColumns = OP == kRows || OP == kWarpStep;
  void (*kernel)(const T*, const int*, T*, int, int, int);
  int64_t smem;
  int bands;
  if constexpr (kColumns) {
    kernel = probe_columns<T, OP>;
    smem = int64_t(M) * kBand * int64_t(sizeof(T));
    bands = (L + kBand - 1) / kBand;
  } else {
    kernel = probe_rows<T, OP>;
    smem = int64_t(M < kRowBand ? M : kRowBand) * L * int64_t(sizeof(T));
    bands = (M + kRowBand - 1) / kRowBand;
  }
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(static_cast<unsigned>(bands), static_cast<unsigned>(passes)),
           kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(idx),
      static_cast<T*>(out), M, L, inner);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int op, const void* x, const void* idx, void* out, int M, int L,
             int inner, int passes, cudaStream_t stream) {
  switch (op) {
    case kRows:
      return launch<T, kRows>(x, idx, out, M, L, inner, passes, stream);
    case kLanes:
      return launch<T, kLanes>(x, idx, out, M, L, inner, passes, stream);
    case kRoll:
      return launch<T, kRoll>(x, idx, out, M, L, inner, passes, stream);
    case kWarpStep:
      return launch<T, kWarpStep>(x, idx, out, M, L, inner, passes, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One probe launch: op (kRows, kLanes, kRoll, kWarpStep), x (M, L) f32 or
// (bf16 != 0) bf16, idx (M, L) int32 (unused by kRoll), out (M, L) like x,
// inner gathers an output, grid passes over the tile. The wrapper
// (liftreg_tpu_torch/ops/gather_probe.py) checks shapes, types, the band's
// shared memory and M * L < 2^31. Returns the launch's CUDA error code.
extern "C" int liftreg_gather_probe(int op, const void* x, int bf16,
                                    const void* idx, void* out, int64_t M,
                                    int64_t L, int inner, int grid,
                                    void* stream) {
  if (M < 1 || L < 1 || M * L >= (int64_t(1) << 31) || inner < 1 ||
      grid < 1 || grid > 65535 || (op != kRoll && idx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(M), l = static_cast<int>(L);
  return bf16 ? dispatch<__nv_bfloat16>(op, x, idx, out, m, l, inner, grid, s)
              : dispatch<float>(op, x, idx, out, m, l, inner, grid, s);
}
