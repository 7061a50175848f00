// Kernel B2: hierarchical brickmap traversal, one CUDA thread per ray.
//
// Replaces the TPU kernel brickmap_tpu/pallas/traverse3.py::_make_kernel
// (:143), launched by _paged_call (:835) behind trace_rays_paged (:868).  It
// computes what that kernel computes after aabb_clip: the top brick-grid DDA
// with Chebyshev empty-space skips (index-word bits 28:20), LoD by squared
// brick distance to the camera (lod_distance_8/2), then per occupied cell a
// coarse hit, a descend into the 2x2x2 LoD byte, a descend into the 8x8x8
// brick, or -- for an unloaded brick -- a hit at the cell face with a
// residency request.  A step budget shared by the three levels sets
// `exhausted` and the resume distance.  The semantics are the reference's
// voxel.cuh:135-261 in the operation order of the plain version
// brickmap_tpu_torch/ops/traverse.py::trace_rays.
//
// The TPU mechanisms are not carried over (page voting over superchunk
// pages, HBM->VMEM page DMA, the one-hot MXU brick fetch): a thread walks the
// scene's flat tensors directly, reading index_volume[cz][cy][cx] once per
// top step and pool_words[pool_base[sc] + (word & 0xFFF)] once per brick
// descend.
//
// What bounds it on an H100: dependent loads on coherent warps, not idle
// lanes.  Each top step waits on one 4-byte index word whose address
// depends on the previous step, each descend step on a word of the brick's
// 64-byte pool row.  Rays' step counts spread from 0 to ~500 around a mean
// of ~40 on a 1080p view, and a warp of 32 rays in launch order runs until
// its longest ray ends, yet notes/probe_torch_b2b3_schedule.py measured
// every schedule that keeps more lanes busy slower on the card: persistent
// warps refilled from a global counter, a loop of one DDA step at any
// level, lanes walking runs of rays.  A launch-order warp is 32
// neighbouring pixels whose loads fall on the same lines, so the kernel
// keeps one thread per ray in launch order.
//
// What the descend costs is the sub-DDA's inner loop.  It is short only
// while the three integer steps stay in registers; when registers run
// short, ptxas re-forms the steps and exit bounds from predicates on every
// step (8 more instructions a loop), which a launch bounds' minimum of
// blocks an SM forces.  So the kernel frees registers held through the
// walk: the entry normal is read in the start cell, where it is used, the
// index word is read unclamped (the cell is inside while the ray is), the
// request position and tmin are applied at the end, and the top step is
// B3's (bm::top_step).  ptxas then builds it in 55 registers (9 blocks an
// SM) with no spills and the short loop.  Small changes to this source
// move ptxas between such builds (55-62 registers, spilling or not, short
// loop or long), so a change here is re-measured with
// notes/probe_torch_b2b3_schedule.py --variants --sass-dir.  The ray and
// scene pointers are separate __restrict__ arguments: nvcc drops the
// qualifier on a struct member.
//
// Measured on the card and not shipped (notes/probe_torch_b2.py): descends
// postponed until several lanes of a warp hold one
// (notes/probe_torch_b2_postpone.cu; a descend step already runs ~15 of
// 32 lanes at view 0's primaries, as the warp merges lanes that enter the
// sub-DDA loop later), a grid of at most the resident blocks fetching rays
// from a cursor (notes/probe_torch_b2_grid.cu: 56 registers and a stack
// frame), 256 or 384 threads a block (the probe's copies of this file with
// kThreads changed), and the skip without its divisions
// (notes/probe_torch_b2_skip_dda.cuh).  Each was slower at the primaries,
// except a product that rounds differently from the division.
//
// The walk itself is traverse_walk.inc, included here and in the wave's
// rescue kernel W4 (wave.cu), which re-traces exhausted rays with the
// escalated budget.  The ray count is read on the device (`count`): the
// wave compacts its live rays there (W0) and sizes this launch to their
// capacity, with no host copy of the count; threads past it return.  (A
// null-tolerant read of the count, `count ? *count : n`, moved ptxas to
// 63 registers; the plain read keeps B2's 55.)
//
// Built by brickmap_tpu_torch/kernels/build.py (nvcc, sm_90a, -fmad=false);
// bound with ctypes by brickmap_tpu_torch/kernels/traverse.py.

#include <cuda_runtime.h>

#include "traverse.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
traverse_kernel(bm::TraverseParams P, int n, const int* __restrict__ count,
                const float* __restrict__ clipped,
                const float* __restrict__ dirs,
                const float* __restrict__ entry_normal,
                const float* __restrict__ tminn,
                const unsigned char* __restrict__ ok,
                const int* __restrict__ iv, const int* __restrict__ pool,
                const int* __restrict__ pool_base,
                unsigned char* __restrict__ hit_out,
                float* __restrict__ t_out, float* __restrict__ normal_out,
                unsigned char* __restrict__ request_out,
                int* __restrict__ request_pos,
                unsigned char* __restrict__ exhausted_out,
                float* __restrict__ resume_out, int* __restrict__ iters_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= *count) return;  // the grid covers the capacity n >= *count

#define BM_DIR(a) dirs[3 * i + (a)]
#define BM_ORIGIN(a) clipped[3 * i + (a)]
#define BM_OK ok[i]
#define BM_ENTRY_NORMAL(a) entry_normal[3 * i + (a)]
#include "traverse_walk.inc"
#undef BM_DIR
#undef BM_ORIGIN
#undef BM_OK
#undef BM_ENTRY_NORMAL

  const float tmin = tminn[i];
  hit_out[i] = hit;
  t_out[i] = bm::hit_distance(hit, t, tmin);
  normal_out[3 * i + 0] = hnx;
  normal_out[3 * i + 1] = hny;
  normal_out[3 * i + 2] = hnz;
  request_out[i] = request;
  request_pos[3 * i + 0] = request ? px : 0;
  request_pos[3 * i + 1] = request ? py : 0;
  request_pos[3 * i + 2] = request ? pz : 0;
  exhausted_out[i] = active;
  resume_out[i] = bm::resume_distance(active, axis0, tx, ty, tz, ax, ay, az,
                                      bszf, tmin);
  iters_out[i] = P.max_iters - budget;
}

}  // namespace

extern "C" int traverse_launch(
    int n, const int* count, const float* clipped, const float* dirs,
    const float* entry_normal, const float* tminn, const unsigned char* ok, const int* index_volume,
    const int* pool_words, const int* pool_base, int cells_x, int cells_y,
    int cells_z, int sc_size, int sc_xy, int num_sc, int cam_x, int cam_y,
    int cam_z, int lod8, int lod2, int brick_size,
    float epsilon, int max_iters, unsigned char* hit, float* t,
    float* normal, unsigned char* request, int* request_pos,
    unsigned char* exhausted, float* resume_t, int* iters, void* stream) {
  const bm::TraverseParams P{cells_x, cells_y, cells_z, sc_size, sc_xy,
                             num_sc,  cam_x,   cam_y,   cam_z,   lod8,
                             lod2,    brick_size, epsilon, max_iters};
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    traverse_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        P, n, count, clipped, dirs, entry_normal, tminn, ok, index_volume,
        pool_words, pool_base, hit, t, normal, request, request_pos,
        exhausted, resume_t, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
