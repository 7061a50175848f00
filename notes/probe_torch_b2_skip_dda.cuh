// csrc/dda.cuh with the forms of the top step's skip that
// notes/probe_torch_b2.py (--b2 K<n>) and notes/probe_torch_skip.py
// (--defines BM_SKIP=<n>) measured and did not ship.  The probes build
// csrc/ with this file in place of its dda.cuh (probe_torch_b2.py::
// skip_overlay); tests/test_torch_traverse_host.py holds its exact forms'
// quotients to the division.  Its default, BM_SKIP 0, is csrc's.
//
// Amanatides-Woo DDA building blocks shared by the brick kernel (brick.cu,
// kernel B1), the hierarchical traversal kernel (traverse.cu, kernel B2)
// and the segment recorder (record.cu, kernel B3).
//
// The arithmetic is the reference's (voxel.cuh:26-133) in the exact
// operation order of the plain torch versions (brickmap_tpu_torch/ops/
// traverse.py and kernels/brick.py), which repeat the JAX package's
// (brickmap_tpu/ops/traverse.py, pallas/brick.py).  The sources are built
// with -fmad=false and without fast math, so every float operation rounds as
// it does on the CPU and DDA boundary decisions match the plain versions.
#pragma once

#include <cstdint>

// How the top step's empty-space skip counts an axis' crossings,
// floorf((t_exit - ta) / td) (top_step, skip_quotient):
//   0  the IEEE division (the plain versions' operation; the default);
//   1  bit for bit without the division where it can: x * rtd, with rtd
//      the correctly rounded 1 / td kept in Axis (one more division a ray),
//      and the division only near an integer or outside [2^-60, 2^60];
//   2  the product x * |d|, which rounds differently: not bit-equal, built
//      only to time what the division costs;
//   3  bit for bit as 1, from the product x * |d| (|d| is within an ulp of
//      1 / td), with no more state in Axis.
// On an H100, 1 took B2 from 55 registers to 64 (W4 to a spill) and 3
// divides at every skip anyway (the axis that sets t_exit has an integer
// quotient by construction): both ran slower than 0 (PERF.md).
#ifndef BM_SKIP
#define BM_SKIP 0
#endif

namespace bm {

constexpr float kBig = 1000000.0f;

// Per-axis ray constants: direction d, 1/d (0 where d == 0) and the
// crossing increment td = sign(d) / d; with BM_SKIP 1 also rtd, 1 / td
// correctly rounded (0 where td == 0).
struct Axis {
  float d, rd, td;
#if BM_SKIP == 1
  float rtd;
#endif
};

__device__ __forceinline__ float sign_f(float d) {
  return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
}

// The integer cell step sign(d).  Not a member of Axis: ptxas keeps it in a
// register where registers allow and otherwise re-forms it from d's sign.
__device__ __forceinline__ int step_of(const Axis& a) {
  return a.d > 0.0f ? 1 : (a.d < 0.0f ? -1 : 0);
}

__device__ __forceinline__ Axis make_axis(float d) {
  Axis a;
  a.d = d;
  a.rd = d == 0.0f ? 0.0f : 1.0f / d;
  a.td = sign_f(d) * a.rd;
#if BM_SKIP == 1
  a.rtd = a.td == 0.0f ? 0.0f : 1.0f / a.td;
#endif
  return a;
}

// DDA start along one axis from origin o (in cells of the level): the cell
// (C truncation) and the t of the first boundary crossing.
__device__ __forceinline__ void axis_start(float o, const Axis& a, int& p,
                                           float& t) {
  p = static_cast<int>(truncf(o));
  const float cb = a.d > 0.0f ? static_cast<float>(p) + 1.0f
                              : static_cast<float>(p);
  t = a.d != 0.0f ? (cb - o) * a.rd : kBig;
}

// Step-axis priority (voxel.cuh:249): x iff strictly smallest, else y iff
// y <= x and y < z, else z.
__device__ __forceinline__ int sel_axis(float tx, float ty, float tz) {
  return tx < ty ? (tx < tz ? 0 : 2) : (ty < tz ? 1 : 2);
}

__device__ __forceinline__ float sel3(int a, float x, float y, float z) {
  return a == 0 ? x : (a == 1 ? y : z);
}

// The 2x2x2 / 8x8x8 DDA (voxel.cuh:26-133) from local origin (ox, oy, oz)
// in cells of the level, at most `budget` occupancy tests; each test costs
// one unit of budget, and the step that leaves the level ends the loop in
// the same unit.  occ(x, y, z) tests a local cell.
//   returns 1: hit; t_local = t of the entry face (0 at the entry cell) and
//              axis = axis of that face (-1 at the entry cell);
//           0: the ray left the level;
//          -1: the budget ran out first.
template <int EXT, class Occ>
__device__ __forceinline__ int sub_dda(float ox, float oy, float oz,
                                       const Axis& ax, const Axis& ay,
                                       const Axis& az, const Occ& occ,
                                       int& budget, float& t_local,
                                       int& axis) {
  int px, py, pz;
  float tx, ty, tz;
  axis_start(ox, ax, px, tx);
  axis_start(oy, ay, py, ty);
  axis_start(oz, az, pz, tz);
  // C's % truncates, like the reference's trunc-mod of the nudged origin.
  px %= EXT;
  py %= EXT;
  pz %= EXT;
  const int outx = ax.d > 0.0f ? EXT : -1;
  const int outy = ay.d > 0.0f ? EXT : -1;
  const int outz = az.d > 0.0f ? EXT : -1;
  int a = -1;
  while (budget > 0) {
    --budget;
    if (occ(px, py, pz)) {
      t_local = a >= 0 ? sel3(a, tx, ty, tz) - sel3(a, ax.td, ay.td, az.td)
                       : 0.0f;
      axis = a;
      return 1;
    }
    a = sel_axis(tx, ty, tz);
    int p, out;
    if (a == 0) {
      px += step_of(ax); p = px; out = outx; tx = tx + ax.td;
    } else if (a == 1) {
      py += step_of(ay); p = py; out = outy; ty = ty + ay.td;
    } else {
      pz += step_of(az); p = pz; out = outz; tz = tz + az.td;
    }
    if (p == out) return 0;
  }
  return -1;
}

// floorf(x / td) of the skip along axis `a` (td 0 read as 1), as BM_SKIP
// says.  For 1 and 3: where td and |x| lie in [2^-60, 2^60], q = x * rtd
// (x * |d|) is within 2 ulps (3 half-ulps relative) of the correctly
// rounded quotient x / td: rtd is 1/2 ulp off 1 / td, and so is |d|, of
// which td is the rounded reciprocal; the product rounds once more.  Both
// are normal and of x's sign, so their floors differ only where q lies
// within 2 ulps of an integer, and q stands unless it lies within
// |q| * 2^-21 of one.  There, and outside that range, the division.
// The host test holds forms 1 and 3 equal to the division on hypothesis'
// floats and on quotients at and next to integers.
__device__ __forceinline__ float skip_quotient(float x, const Axis& a) {
#if BM_SKIP == 1 || BM_SKIP == 3
  const float ax = fabsf(x);
  if (a.td >= 0x1p-60f && a.td <= 0x1p60f && ax >= 0x1p-60f &&
      ax <= 0x1p60f) {
#if BM_SKIP == 1
    const float q = x * a.rtd;
#else
    const float q = x * fabsf(a.d);
#endif
    const float f = floorf(q);
    const float tol = fabsf(q) * 0x1p-21f;
    if (q - f > tol && (f + 1.0f) - q > tol) return f;
  }
#elif BM_SKIP == 2
  return floorf(x * fabsf(a.d));
#endif
  return floorf(x / (a.td == 0.0f ? 1.0f : a.td));
}

// One top-level step of kernels B2 and B3 out of the cell (px, py, pz),
// which is inside the grid, whose index word is `word` and whose flag bits
// say `occ`.  From an empty cell with skip radius R >= 1 (bits 28:20, minus
// one) every cell within L-inf distance R is empty: jump each axis by its
// crossing count up to the first crossing that leaves that box; otherwise
// step the axis sel_axis picks.  Sets axis0 to the entry face of the new
// cell (the latest crossing among the stepped axes) and returns false when
// the step left the grid.
__device__ __forceinline__ bool top_step(unsigned int word, bool occ,
                                         const Axis& ax, const Axis& ay,
                                         const Axis& az, int cx, int cy,
                                         int cz, int& px, int& py, int& pz,
                                         float& tx, float& ty, float& tz,
                                         int& axis0) {
  const int skip_r = max(static_cast<int>((word >> 20) & 0x1FFu) - 1, 0);
  const int a1 = sel_axis(tx, ty, tz);
  int kx = a1 == 0, ky = a1 == 1, kz = a1 == 2;
  if (!occ && skip_r >= 1) {
    const float rf = static_cast<float>(skip_r);
    const float t_exit = fminf(fminf(ax.d != 0.0f ? tx + rf * ax.td : kBig,
                                     ay.d != 0.0f ? ty + rf * ay.td : kBig),
                               az.d != 0.0f ? tz + rf * az.td : kBig);
    auto k_axis = [&](const Axis& a, float ta) {
      if (a.d == 0.0f) return 0;
      const int k = static_cast<int>(skip_quotient(t_exit - ta, a)) + 1;
      return min(max(k, 0), skip_r + 1);
    };
    const int jx = k_axis(ax, tx), jy = k_axis(ay, ty), jz = k_axis(az, tz);
    if (jx + jy + jz != 0) {  // a degenerate jump falls back to one step
      kx = jx; ky = jy; kz = jz;
    }
  }
  px += step_of(ax) * kx;
  py += step_of(ay) * ky;
  pz += step_of(az) * kz;
  tx = tx + static_cast<float>(kx) * ax.td;
  ty = ty + static_cast<float>(ky) * ay.td;
  tz = tz + static_cast<float>(kz) * az.td;
  const float tlx = kx > 0 ? tx - ax.td : -kBig;
  const float tly = ky > 0 ? ty - ay.td : -kBig;
  const float tlz = kz > 0 ? tz - az.td : -kBig;
  axis0 = tlx > tly ? (tlx > tlz ? 0 : 2) : (tly > tlz ? 1 : 2);
  // The cell was inside and each axis moves only along its direction, so
  // the step left the grid iff a coordinate passed cx/cy/cz upwards or 0
  // downwards: one unsigned compare per axis.
  return static_cast<unsigned int>(px) < static_cast<unsigned int>(cx) &&
         static_cast<unsigned int>(py) < static_cast<unsigned int>(cy) &&
         static_cast<unsigned int>(pz) < static_cast<unsigned int>(cz);
}

}  // namespace bm
