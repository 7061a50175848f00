// Amanatides-Woo DDA building blocks shared by the brick kernel (brick.cu,
// kernel B1) and the hierarchical traversal kernel (traverse.cu, kernel B2).
//
// The arithmetic is the reference's (voxel.cuh:26-133) in the exact
// operation order of the plain torch versions (brickmap_tpu_torch/ops/
// traverse.py and kernels/brick.py), which repeat the JAX package's
// (brickmap_tpu/ops/traverse.py, pallas/brick.py).  The sources are built
// with -fmad=false and without fast math, so every float operation rounds as
// it does on the CPU and DDA boundary decisions match the plain versions.
#pragma once

#include <cstdint>

namespace bm {

constexpr float kBig = 1000000.0f;

// Per-axis ray constants: direction d, 1/d (0 where d == 0), the crossing
// increment td = sign(d) / d and the integer step sign(d).
struct Axis {
  float d, rd, td;
  int step;
};

__device__ __forceinline__ float sign_f(float d) {
  return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ Axis make_axis(float d) {
  Axis a;
  const float sf = sign_f(d);
  a.d = d;
  a.rd = d == 0.0f ? 0.0f : 1.0f / d;
  a.td = sf * a.rd;
  a.step = static_cast<int>(sf);
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
      px += ax.step; p = px; out = outx; tx = tx + ax.td;
    } else if (a == 1) {
      py += ay.step; p = py; out = outy; ty = ty + ay.td;
    } else {
      pz += az.step; p = pz; out = outz; tz = tz + az.td;
    }
    if (p == out) return 0;
  }
  return -1;
}

}  // namespace bm
