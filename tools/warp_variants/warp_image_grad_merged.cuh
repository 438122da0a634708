// Variant of add_terms in liftreg_tpu_torch/csrc/warp_trilinear.cu for
// tools/torch_image_grad_sweep.py (the sweep puts it in the place of the
// source's add_terms): before the atomics, the terms that neighbouring
// points add to the same tap are summed in registers, along z within a
// thread (a thread's points are consecutive in z where TY * TX = THREADS)
// and along x between lanes (warp shuffles). Same values up to the order of
// each tap's sum.

// The 2 x 2 (y, x) taps of a point's lower (z.i0) or upper (z.i1) z plane,
// in (dy, dx) order: their offsets ((z - oz) * sy + y - oy) * sx + x - ox,
// and which have a nonzero weight (bit k)
__device__ __forceinline__ int plane_taps(const Axis& z, const Axis& y,
                                          const Axis& x, bool upper, int oz,
                                          int oy, int ox, int sy, int sx,
                                          int* off) {
  const int zi = upper ? z.i1 : z.i0;
  const float wz = upper ? z.w1 : z.w0;
  const float wyx[4] = {__fmul_rn(y.w0, x.w0), __fmul_rn(y.w0, x.w1),
                        __fmul_rn(y.w1, x.w0), __fmul_rn(y.w1, x.w1)};
  int live = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    off[k] = ((zi - oz) * sy + ((k >> 1) ? y.i1 : y.i0) - oy) * sx +
             ((k & 1) ? x.i1 : x.i0) - ox;
    if (wz != 0.f && wyx[k] != 0.f) live |= 1 << k;
  }
  return live;
}

// the terms of that plane for cotangent gv: (gv * w_z) * (w_y * w_x)
__device__ __forceinline__ void plane_terms(const Axis& z, const Axis& y,
                                            const Axis& x, bool upper,
                                            float gv, float* v) {
  const float gz = __fmul_rn(gv, upper ? z.w1 : z.w0);
  v[0] = __fmul_rn(gz, __fmul_rn(y.w0, x.w0));
  v[1] = __fmul_rn(gz, __fmul_rn(y.w0, x.w1));
  v[2] = __fmul_rn(gz, __fmul_rn(y.w1, x.w0));
  v[3] = __fmul_rn(gz, __fmul_rn(y.w1, x.w1));
}

// Which terms of a plane's two x rows pass between lanes: a lane takes (bit
// r of take) the previous lane's live x1 term of row r where it falls on
// this lane's x0 tap, and that lane gives it (bit r of give). Every lane of
// the warp calls it together; a dead term passes offset INT_MIN, which no
// offset equals.
__device__ __forceinline__ void row_links(const int* off, int live,
                                          int& take, int& give) {
  const int lane = threadIdx.x & 31;
  take = give = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool l1 = (live >> (2 * r + 1)) & 1;
    const int prev_off1 =
        __shfl_up_sync(0xffffffffu, l1 ? off[2 * r + 1] : INT_MIN, 1);
    const int next_off0 = __shfl_down_sync(0xffffffffu, off[2 * r], 1);
    if (lane > 0 && prev_off1 == off[2 * r]) take |= 1 << r;
    if (lane < 31 && l1 && next_off0 == off[2 * r + 1]) give |= 1 << r;
  }
}

// Add a plane's terms v at base + off, a term given away added with the
// taker's own. Every lane of the warp calls it together.
__device__ __forceinline__ void add_plane(float* base, const int* off,
                                          const float* v, int live, int take,
                                          int give) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float prev_v1 = __shfl_up_sync(0xffffffffu, v[2 * r + 1], 1);
    const bool l0 = (live >> (2 * r)) & 1, l1 = (live >> (2 * r + 1)) & 1;
    const bool t = (take >> r) & 1, gv = (give >> r) & 1;
    if (l0 || t)
      atomicAdd(base + off[2 * r],
                t ? (l0 ? __fadd_rn(v[2 * r], prev_v1) : prev_v1)
                  : v[2 * r]);
    if (l1 && !gv) atomicAdd(base + off[2 * r + 1], v[2 * r + 1]);
  }
}

// add_terms' contract. Plane s lies between point s - 1's upper z taps and
// point s's lower ones, summed in registers and added once where they are
// the same four taps; which terms merge is found once for all channels.
__device__ __forceinline__ void add_terms(
    float* base, int64_t cstride, int nch,
    const float (&gv)[kImgChan][kImgPts], const Axis* az, const Axis* ay,
    const Axis* ax, int oz, int oy, int ox, int sy, int sx) {
#pragma unroll
  for (int s = 0; s <= kImgPts; ++s) {
    int offA[4], offB[4], liveU = 0, liveL = 0, liveB = 0;
    if (s > 0)
      liveU = plane_taps(az[s - 1], ay[s - 1], ax[s - 1], true, oz, oy, ox,
                         sy, sx, offA);
    if (s < kImgPts) {
      liveB = plane_taps(az[s], ay[s], ax[s], false, oz, oy, ox, sy, sx,
                         offB);
      if (s > 0 && az[s].i0 == az[s - 1].i1 && ay[s].i0 == ay[s - 1].i0 &&
          ay[s].i1 == ay[s - 1].i1 && ax[s].i0 == ax[s - 1].i0 &&
          ax[s].i1 == ax[s - 1].i1) {
        liveL = liveB;
        liveB = 0;
      }
    }
    const int liveA = liveU | liveL;
    const bool anyA = __any_sync(0xffffffffu, liveA != 0);
    const bool anyB = __any_sync(0xffffffffu, liveB != 0);
    int takeA = 0, giveA = 0, takeB = 0, giveB = 0;
    if (anyA) row_links(offA, liveA, takeA, giveA);
    if (anyB) row_links(offB, liveB, takeB, giveB);
    if (!anyA && !anyB) continue;
#pragma unroll
    for (int cl = 0; cl < kImgChan; ++cl) {
      if (cl >= nch) break;
      float* bc = base + cl * cstride;
      if (anyA) {
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (s > 0 && liveU)
          plane_terms(az[s - 1], ay[s - 1], ax[s - 1], true, gv[cl][s - 1],
                      v);
        if (s < kImgPts && liveL) {
          float w[4];
          plane_terms(az[s], ay[s], ax[s], false, gv[cl][s], w);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if ((liveL >> k) & 1)
              v[k] = (liveU >> k) & 1 ? __fadd_rn(v[k], w[k]) : w[k];
        }
        add_plane(bc, offA, v, liveA, takeA, giveA);
      }
      if (anyB) {
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (s < kImgPts && liveB)
          plane_terms(az[s], ay[s], ax[s], false, gv[cl][s], v);
        add_plane(bc, offB, v, liveB, takeB, giveB);
      }
    }
  }
}
