// What kernel B2 (traverse.cu) and the rescue kernel W4 (wave.cu) share:
// the scene's parameters and index-word flags as the walk reads them, the
// walk itself, traverse_walk.inc, which both include in their kernels, and
// the outputs both make of the walk's state.
#pragma once

#include "dda.cuh"

namespace bm {

constexpr unsigned int kFlagBits = 0xE0000000u;
constexpr unsigned int kLoadedBit = 0x80000000u;
constexpr unsigned int kUnloadedBit = 0x40000000u;

struct TraverseParams {
  int cx, cy, cz;           // brick-grid extents
  int sc, sc_xy, num_sc;    // superchunk edge in bricks, per xy row, count
  int cam_x, cam_y, cam_z;  // camera position in bricks (LoD origin)
  int lod8, lod2;           // squared brick distances of the LoD switches
  int bsz;                  // brick edge in voxels
  float eps;
  int max_iters;            // DDA steps per ray, shared by the three levels
};

// The hit's distance along the ray from the box entry at tmin (0 for a
// miss or an exhausted ray), from the walk's t past the clipped origin.
__device__ __forceinline__ float hit_distance(bool hit, float t, float tmin) {
  return hit ? t + tmin : 0.0f;
}

// An exhausted (still active) ray's resume distance: the entry t of the
// top cell it stopped in, in world units along the ray from the box entry
// at tmin; 0 for a ray that ended.
__device__ __forceinline__ float resume_distance(bool active, int axis0,
                                                 float tx, float ty, float tz,
                                                 const Axis& ax,
                                                 const Axis& ay,
                                                 const Axis& az, float bszf,
                                                 float tmin) {
  if (!active) return 0.0f;
  const float rc = axis0 >= 0 ? sel3(axis0, tx, ty, tz) -
                                    sel3(axis0, ax.td, ay.td, az.td)
                              : 0.0f;
  return fmaxf(rc * bszf + tmin, 0.0f);
}

}  // namespace bm
