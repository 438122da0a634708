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
// grid): every pass stages and gathers the whole tile and writes the same
// values to the same output.
//
// Bound: each gathered element is one shared-memory read (4 B in f32), at
// 128 B a clock an SM: ~33 TB/s over 132 SMs at 1.98 GHz (the card's
// clocks.max.sm gives the clock), or the device-memory bytes of x, idx and
// out at 3.35 TB/s, whichever is larger; at the probes' tiles the first.
//
// Design. The tile is staged in shared memory in bands, with cp.async
// where rows are 16-byte aligned, while each thread loads its first
// indices; the indices stay in registers. Only the wrapped copies (below)
// that inner taps can reach are staged.
// - Axis 0 (kRows, kWarpStep): an output reads only its own column, so a
//   block stages all M rows of a band of W columns and the lanes of a warp
//   take the band's columns of one row. W is 32 (f32: element (r, c) in
//   bank c) or, for bf16, 64: lane l takes column 2l in one half-step and
//   2l + 1 in the other, so in either half-step it reads bank l whatever
//   row it gathers. Neither gather has a bank conflict. A bf16 band with
//   1816 < M <= 3632 rows fits only 32 columns wide; there lanes 2m and
//   2m + 1 share bank m mod 16 + 16 (r mod 2), a 2-way conflict when they
//   gather different rows of one parity. Where the bench's split of the
//   card leaves fewer than ~2 blocks an SM (one pass), a band's output
//   rows are split over up to 16 blocks, each staging the whole band.
// - Axis 1 (kLanes, kRoll): an output reads only its own row, so a block
//   stages up to 8 whole rows (fewer where one pass leaves the card
//   empty), and the lanes of a warp take neighbouring columns of a row.
//   The roll reads neighbouring columns (no conflict); the lane gather
//   reads arbitrary ones, whose bank conflicts are the cost this probe
//   exists to measure, and are left as they are.
// - No division in the k loop. An output's first tap position
//   j = (idx mod n) is computed once; the taps are read in blocks of
//   kUnroll (7 for the warp step, whose mask then repeats from block to
//   block), each block from one base address with immediate offsets,
//   loads issued before the dependent adds. The staged line carries
//   kUnroll - 1 wrapped copies past its end (the roll, which walks down,
//   before its start), so a block never wraps inside; between blocks j
//   moves on by kUnroll mod n with one compare. Where i + k passes
//   INT32_MAX (i > INT32_MAX - inner + 1) the walk restarts once at
//   floor_mod(INT32_MIN, n). Where the copies do not fit shared memory
//   (tiles at its edge), the same walk runs one tap a block without them.
// - Blocks hold 256 threads, or 512 or 1024 where a band leaves room for
//   only two or three blocks, or one, on an SM (so that an SM keeps ~32
//   warps), and no more than their outputs need. An axis-0 warp loads the
//   indices of its next 2 rows, an axis-1 thread its next output's, while
//   it gathers.
// Measured on the H100 with tools/torch_gather_probe_sweep.py, which
// builds each of these choices undone: cp.async, the row split, the
// 1024-thread blocks, the unrolled walk and the division-free modulo each
// pay at some of the probes' settings (PERF.md).
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Op { kRows = 0, kLanes = 1, kRoll = 2, kWarpStep = 3 };

constexpr int kMaxThreads = 1024;
constexpr int kInFlight = 2;     // axis-0 rows whose indices a warp loads ahead
constexpr int kMaxRowBand = 8;   // rows of an axis-1 band
constexpr int kMaxSplits = 16;   // blocks an axis-0 band's rows go to
constexpr int kFront = 8;        // elements before an axis-1 row (16 B-aligned)
// shared memory a block may use, and an SM holds, on an H100; the runtime
// keeps 1 KB of an SM's for each block
constexpr int64_t kMaxSmem = 232448;
constexpr int64_t kSmSmem = 233472;
constexpr int64_t kBlockReserve = 1024;

template <int OP>
constexpr int kUnroll = OP == kWarpStep ? 7 : 8;

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

// floor_mod(i, n) for any int32 i and one n >= 1 without a division:
// u = i + 2^31 as unsigned, u mod n by a multiply-high (Granlund and
// Montgomery's round-up method, exact for every 32-bit u), less 2^31 mod n
struct FloorMod {
  unsigned magic;
  int sh1, sh2, n, bias;
  static FloorMod of(int n) {
    int l = 0;
    while ((uint64_t(1) << l) < static_cast<uint64_t>(n)) ++l;
    const uint64_t m =
        (uint64_t(1) << 32) * ((uint64_t(1) << l) - uint64_t(n)) /
            uint64_t(n) + 1;
    return {static_cast<unsigned>(m), l < 1 ? l : 1, l > 1 ? l - 1 : 0, n,
            static_cast<int>((uint64_t(1) << 31) % uint64_t(n))};
  }
  __device__ __forceinline__ int operator()(int i) const {
    const unsigned u = static_cast<unsigned>(i) ^ 0x80000000u;
    const unsigned t = __umulhi(magic, u);
    const unsigned q = (t + ((u - t) >> sh1)) >> sh2;
    const int r = static_cast<int>(u - q * static_cast<unsigned>(n)) - bias;
    return r < 0 ? r + n : r;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// kRows and kLanes: each tap added, rounded as the tile's type rounds
template <typename T>
struct SumTaps {
  __device__ __forceinline__ float operator()(float acc, float v, int) const {
    return Num<T>::round(__fadd_rn(acc, v));
  }
  __device__ __forceinline__ void next() {}
  __device__ __forceinline__ void restart(int) {}
};

// kWarpStep: tap u of a block of U is weighted and added where bit u of
// `keep` is set (the block's k mod 7 == idx mod 7), else +0 is added; each
// tap is read either way
template <typename T, int U>
struct MaskedTaps {
  float w;
  int phase;
  unsigned keep;
  __device__ __forceinline__ MaskedTaps(float w_, int phase_)
      : w(w_), phase(phase_), keep(1u << phase_) {}
  __device__ __forceinline__ float operator()(float acc, float g,
                                              int u) const {
    const float v =
        (keep >> u) & 1u ? Num<T>::round(__fmul_rn(g, w)) : 0.f;
    return Num<T>::round(__fadd_rn(acc, v));
  }
  // the next block starts U taps on: turn the 7-bit pattern by U mod 7
  __device__ __forceinline__ void next() {
    if constexpr (U % 7 != 0)
      keep = ((keep >> (U % 7)) | (keep << (7 - U % 7))) & 0x7fu;
  }
  // a block that starts at tap k
  __device__ __forceinline__ void restart(int k) {
    keep = 1u << floor_mod(phase - k % 7, 7);
  }
};

// `count` taps at walk positions j, j + 1, ... (mod n) of a staged line
// whose position q is origin[q * D], U - 1 wrapped copies beyond position
// n - 1; step = U mod n. Returns acc with the taps added in order.
template <typename T, int U, int D, typename Taps>
__device__ __forceinline__ float walk(const T* origin, int j, int n,
                                      int step, int count, float acc,
                                      Taps& taps) {
  for (; count >= U; count -= U) {
    const T* p = origin + j * D;
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = Num<T>::load(p[u * D]);
#pragma unroll
    for (int u = 0; u < U; ++u) acc = taps(acc, v[u], u);
    taps.next();
    j += step;
    if (j >= n) j -= n;
  }
  if (count > 0) {
    const T* p = origin + j * D;
#pragma unroll
    for (int u = 0; u < U - 1; ++u)
      if (u < count) acc = taps(acc, Num<T>::load(p[u * D]), u);
  }
  return acc;
}

// the taps (i + k) mod n, k < inner, with i + k wrapping in 32 bits: one
// walk from i mod n, and where i + k passes INT32_MAX a second from
// INT32_MIN mod n
template <typename T, int U, int D, typename Taps>
__device__ __forceinline__ float index_walk(const T* origin, int i,
                                            const FloorMod& mod, int step,
                                            int inner, Taps& taps) {
  const int before = i > INT_MAX - (inner - 1) ? INT_MAX - i + 1 : inner;
  float acc = walk<T, U, D>(origin, mod(i), mod.n, step, before, 0.f, taps);
  if (before < inner) {
    taps.restart(before);
    acc = walk<T, U, D>(origin, mod(INT_MIN), mod.n, step, inner - before,
                        acc, taps);
  }
  return acc;
}

// kRows and kWarpStep: block (band * splits + part, pass) stages rows
// 0 .. M + min(inner, U) - 2 (row r holding x's row r mod M) of columns
// [W band, W band + W) and computes the rows [M part / splits,
// M (part + 1) / splits); warp w takes every warps-th of them from the
// w-th, each lane W / 32 columns of a row
template <typename T, int OP, int W, int U>
__global__ void __launch_bounds__(kMaxThreads)
    probe_columns(const T* __restrict__ x, const int* __restrict__ idx,
                  T* __restrict__ out, int M, int L, int inner, int splits,
                  int vec, FloorMod mod) {
  constexpr int kOut = W / 32;  // outputs a lane takes in a row
  extern __shared__ __align__(16) unsigned char smem[];
  T* band = reinterpret_cast<T*>(smem);
  const int bandno = blockIdx.x / splits;
  const int part = blockIdx.x - bandno * splits;
  const int col0 = bandno * W;
  // the wrapped copies that inner taps can reach
  const int rows = M + min(inner, U) - 1;
  if (vec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    constexpr int kChunks = W / kPer;
    for (int e = threadIdx.x; e < rows * kChunks; e += blockDim.x) {
      const int r = e / kChunks, c = col0 + (e % kChunks) * kPer;
      const int src = r < M ? r : (r - M) % M;
      if (c < L) cp_async16(band + r * W + c - col0, x + src * L + c);
    }
  }

  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int r_begin = static_cast<int>(int64_t(part) * M / splits);
  const int r_end = static_cast<int>(int64_t(part + 1) * M / splits);
  const int batch = kInFlight * warps;
  int col[kOut];
  bool live[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    col[o] = col0 + lane * kOut + o;
    live[o] = col[o] < L;
  }
  int cur[kInFlight][kOut], nxt[kInFlight][kOut];
  auto load = [&](int (&iv)[kInFlight][kOut], int r0) {
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const int r = r0 + u * warps;
        iv[u][o] = r < r_end && live[o] ? idx[r * L + col[o]] : 0;
      }
  };
  int r0 = r_begin + (threadIdx.x >> 5);
  load(cur, r0);
  if (!vec) {
    for (int e = threadIdx.x; e < rows * W; e += blockDim.x) {
      const int r = e / W, c = col0 + e % W;
      const int src = r < M ? r : (r - M) % M;
      band[e] = c < L ? x[src * L + c] : Num<T>::store(0.f);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  const int step = U % M;
  for (; r0 < r_end; r0 += batch) {
    load(nxt, r0 + batch);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int r = r0 + u * warps;
      if (r >= r_end) break;
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        if (!live[o]) continue;
        const T* line = band + lane * kOut + o;
        float acc;
        if constexpr (OP == kRows) {
          SumTaps<T> taps;
          acc = index_walk<T, U, W>(line, cur[u][o], mod, step, inner,
                                    taps);
        } else {
          MaskedTaps<T, U> taps(
              Num<T>::round(__fmul_rn(Num<T>::load(line[r * W]), 0.25f)),
              floor_mod(cur[u][o], 7));
          acc = index_walk<T, U, W>(line, cur[u][o], mod, step, inner,
                                    taps);
        }
        out[r * L + col[o]] = Num<T>::store(acc);
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
#pragma unroll
      for (int o = 0; o < kOut; ++o) cur[u][o] = nxt[u][o];
  }
}

// elements of an axis-1 row as staged: U - 1 wrapped copies each side of
// the L columns (kFront before them), rounded up to 8 (16 B-aligned rows)
template <int U>
__host__ __device__ __forceinline__ int row_stride(int L) {
  return U > 1 ? kFront + (L + U - 1 + 7) / 8 * 8 : (L + 7) / 8 * 8;
}

// kLanes and kRoll: block (band, pass) stages rows [R band, R band + R)
// whole, with their wrapped copies; thread t computes elements t,
// t + blockDim.x, ... of the band
template <typename T, int OP, int U>
__global__ void __launch_bounds__(kMaxThreads)
    probe_rows(const T* __restrict__ x, const int* __restrict__ idx,
               T* __restrict__ out, int M, int L, int inner, int R,
               int vec, FloorMod mod) {
  constexpr int kLead = U > 1 ? kFront : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  T* rows = reinterpret_cast<T*>(smem);
  const int S = row_stride<U>(L);
  const int r0 = blockIdx.x * R;
  const int nr = min(R, M - r0);
  const int base = r0 * L;
  if (vec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    // a warp a row, or where a row has a chunk for every thread the whole
    // block along each row (no division for the chunk's row)
    const bool wide = L / kPer >= static_cast<int>(blockDim.x);
    const int lane = wide ? threadIdx.x : threadIdx.x & 31;
    const int lanes = wide ? blockDim.x : 32;
    for (int r = wide ? 0 : threadIdx.x >> 5; r < nr;
         r += wide ? 1 : blockDim.x >> 5)
      for (int c = lane * kPer; c < L; c += lanes * kPer)
        cp_async16(rows + r * S + kLead + c, x + base + r * L + c);
  }

  const int n = nr * L, stride = blockDim.x;
  const int dr = stride / L, dc = stride - dr * L;
  // the next output's index is loaded ahead (more in flight lengthened
  // the kernel and its latency at one pass, and gained nothing)
  auto load = [&](int e) {
    return OP == kLanes && e < n ? idx[base + e] : 0;
  };
  int e = threadIdx.x;
  int r = e / L, c = e - (e / L) * L;
  int cur = load(e);
  // the wrapped copies that inner taps can reach, each side of the row,
  // and where rows are not 16 B-aligned every column
  const int pad = min(inner, U) - 1;
  const int body = vec ? 0 : L;
  const int edge = 2 * pad + body;  // elements a row staged here
  for (int q0 = threadIdx.x; q0 < nr * edge; q0 += blockDim.x) {
    const int rr = q0 / edge, t = q0 - rr * edge;
    const int q = t < pad ? kLead - pad + t : kLead + L - body + t - pad;
    int col = q - kLead;
    if (col < 0 || col >= L) col = floor_mod(col, L);
    rows[rr * S + q] = x[base + rr * L + col];
  }
  cp_async_wait_all();
  __syncthreads();
  const int step = U % L;
  for (; e < n; e += stride) {
    const int nxt = load(e + stride);
    const T* line = rows + r * S + kLead;
    SumTaps<T> taps;
    float acc;
    if constexpr (OP == kLanes) {
      acc = index_walk<T, U, 1>(line, cur, mod, step, inner, taps);
    } else {
      // column (c - 1 - k) mod L is walk position L - 1 - column of the
      // line read backwards from its last column
      acc = walk<T, U, -1>(line + L - 1, c == 0 ? 0 : L - c, L, step, inner,
                           0.f, taps);
    }
    out[base + e] = Num<T>::store(acc);
    cur = nxt;
    r += dr;
    c += dc;
    if (c >= L) {
      c -= L;
      ++r;
    }
  }
}

int ceil_div(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }

// threads of a block with `smem` bytes: ~32 warps an SM, and no more than
// `need`
int block_threads(int64_t smem, int64_t need) {
  const int64_t blocks = kSmSmem / (smem + kBlockReserve);
  const int64_t t = blocks >= 4 ? 256 : blocks >= 2 ? 512 : kMaxThreads;
  const int64_t want = (need + 31) / 32 * 32;
  return static_cast<int>(want < t ? want : t);
}

struct Launch {
  const void* x;
  const int* idx;
  void* out;
  int M, L, inner, passes, sms, vec;
  cudaStream_t stream;
};

template <typename T, int OP, int W, int U>
int columns(const Launch& a) {
  const int64_t smem = int64_t(a.M + U - 1) * W * int64_t(sizeof(T));
  const int bands = ceil_div(a.L, W);
  int splits = ceil_div(2 * int64_t(a.sms), int64_t(bands) * a.passes);
  splits = splits < kMaxSplits ? splits : kMaxSplits;
  const int most = ceil_div(a.M, 8);
  splits = splits < most ? splits : most;
  const int threads = block_threads(smem, 32 * int64_t(ceil_div(a.M, splits)));
  auto kernel = probe_columns<T, OP, W, U>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(static_cast<unsigned>(bands * splits),
                static_cast<unsigned>(a.passes)),
           threads, static_cast<size_t>(smem), a.stream>>>(
      static_cast<const T*>(a.x), a.idx, static_cast<T*>(a.out), a.M, a.L,
      a.inner, splits, a.vec, FloorMod::of(a.M));
  return static_cast<int>(cudaGetLastError());
}

// the band W columns wide, with its wrapped copies where they fit
template <typename T, int OP, int W>
int columns_of_width(const Launch& a) {
  constexpr int U = kUnroll<OP>;
  if (int64_t(a.M + U - 1) * W * int64_t(sizeof(T)) <= kMaxSmem)
    return columns<T, OP, W, U>(a);
  return columns<T, OP, W, 1>(a);
}

template <typename T, int OP>
int launch_columns(const Launch& a) {
  if (int64_t(a.M) * 32 * int64_t(sizeof(T)) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (sizeof(T) == 2 && int64_t(a.M) * 64 * 2 <= kMaxSmem)
    return columns_of_width<T, OP, 64>(a);
  return columns_of_width<T, OP, 32>(a);
}

template <typename T, int OP, int U>
int rows_of(const Launch& a, int R) {
  const int64_t smem = int64_t(R) * row_stride<U>(a.L) * int64_t(sizeof(T));
  const int threads = block_threads(smem, int64_t(R) * a.L);
  auto kernel = probe_rows<T, OP, U>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(static_cast<unsigned>(ceil_div(a.M, R)),
                static_cast<unsigned>(a.passes)),
           threads, static_cast<size_t>(smem), a.stream>>>(
      static_cast<const T*>(a.x), a.idx, static_cast<T*>(a.out), a.M, a.L,
      a.inner, R, a.vec, FloorMod::of(a.L));
  return static_cast<int>(cudaGetLastError());
}

// rows a block: up to 8, fewer where one pass would leave SMs without two
// blocks, and fewer again until the band with its wrapped copies fits
template <typename T, int OP>
int launch_rows(const Launch& a) {
  const int most = a.M < kMaxRowBand ? a.M : kMaxRowBand;
  if (int64_t(most) * a.L * int64_t(sizeof(T)) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  int R = static_cast<int>(int64_t(a.M) * a.passes / (2 * int64_t(a.sms)));
  R = R < 1 ? 1 : R > most ? most : R;
  constexpr int U = kUnroll<OP>;
  auto bytes = [&](int r, int stride) {
    return int64_t(r) * stride * int64_t(sizeof(T));
  };
  for (int r = R; r >= 1; --r)
    if (bytes(r, row_stride<U>(a.L)) <= kMaxSmem) return rows_of<T, OP, U>(a, r);
  for (int r = R; r >= 1; --r)
    if (bytes(r, row_stride<1>(a.L)) <= kMaxSmem) return rows_of<T, OP, 1>(a, r);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(int op, const Launch& a) {
  switch (op) {
    case kRows:
      return launch_columns<T, kRows>(a);
    case kWarpStep:
      return launch_columns<T, kWarpStep>(a);
    case kLanes:
      return launch_rows<T, kLanes>(a);
    case kRoll:
      return launch_rows<T, kRoll>(a);
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
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int size = bf16 ? 2 : 4;
  // 16-byte chunks of x's rows can be copied with cp.async
  const int vec = (L * size) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const Launch a{x, static_cast<const int*>(idx), out, static_cast<int>(M),
                 static_cast<int>(L), inner, grid, sms, vec,
                 static_cast<cudaStream_t>(stream)};
  return bf16 ? dispatch<__nv_bfloat16>(op, a) : dispatch<float>(op, a);
}
