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
// Built by brickmap_tpu_torch/kernels/build.py (nvcc, sm_90a, -fmad=false);
// bound with ctypes by brickmap_tpu_torch/kernels/traverse.py.

#include <cuda_runtime.h>

#include "dda.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned int kFlagBits = 0xE0000000u;
constexpr unsigned int kLoadedBit = 0x80000000u;
constexpr unsigned int kUnloadedBit = 0x40000000u;

struct Params {
  int cx, cy, cz;           // brick-grid extents
  int sc, sc_xy, num_sc;    // superchunk edge in bricks, per xy row, count
  int cam_x, cam_y, cam_z;  // camera position in bricks (LoD origin)
  int lod8, lod2;           // squared brick distances of the LoD switches
  int bsz;                  // brick edge in voxels
  float eps;
  int max_iters;            // DDA steps per ray, shared by the three levels
};

__global__ void __launch_bounds__(kThreads)
traverse_kernel(Params P, int n, const float* __restrict__ clipped,
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
  if (i >= n) return;

  const float bszf = static_cast<float>(P.bsz);
  const bm::Axis ax = bm::make_axis(dirs[3 * i + 0]);
  const bm::Axis ay = bm::make_axis(dirs[3 * i + 1]);
  const bm::Axis az = bm::make_axis(dirs[3 * i + 2]);
  const float ox = clipped[3 * i + 0] / bszf;
  const float oy = clipped[3 * i + 1] / bszf;
  const float oz = clipped[3 * i + 2] / bszf;

  int px, py, pz;
  float tx, ty, tz;
  bm::axis_start(ox, ax, px, tx);
  bm::axis_start(oy, ay, py, ty);
  bm::axis_start(oz, az, pz, tz);
  bool active = ok[i] && px >= 0 && px < P.cx && py >= 0 && py < P.cy &&
                pz >= 0 && pz < P.cz;

  int budget = P.max_iters;
  int axis0 = -1;  // axis of the face through which the current top cell
                   // was entered (-1: the start cell)
  bool hit = false, request = false;
  float t = 0.0f, hnx = 0.0f, hny = 0.0f, hnz = 0.0f;

  while (active) {
    if (budget == 0) break;  // exhausted: `active` stays set
    --budget;
    // In bounds while active (the plain version clamps, to no effect).
    const unsigned int word =
        static_cast<unsigned int>(iv[(pz * P.cy + py) * P.cx + px]);
    const bool occ0 = (word & kFlagBits) != 0u;
    if (occ0) {
      // Entry distance (cells) and face normal of the current top cell.
      float nd = 0.0f, ntx, nty, ntz;
      if (axis0 >= 0) {
        nd = bm::sel3(axis0, tx, ty, tz) -
             bm::sel3(axis0, ax.td, ay.td, az.td);
        const float sf = bm::sel3(axis0, bm::sign_f(ax.d), bm::sign_f(ay.d),
                                  bm::sign_f(az.d));
        ntx = axis0 == 0 ? -sf : 0.0f;
        nty = axis0 == 1 ? -sf : 0.0f;
        ntz = axis0 == 2 ? -sf : 0.0f;
      } else {  // the start cell: the face the ray entered the box by
        ntx = entry_normal[3 * i + 0];
        nty = entry_normal[3 * i + 1];
        ntz = entry_normal[3 * i + 2];
      }
      const int ddx = P.cam_x - px, ddy = P.cam_y - py, ddz = P.cam_z - pz;
      const int d2 = ddx * ddx + ddy * ddy + ddz * ddz;
      const bool far = d2 > P.lod8;
      const bool mid = !far && d2 > P.lod2;
      if (far) {  // brick-granular hit
        hit = true;
        t = nd * bszf;
        hnx = ntx; hny = nty; hnz = ntz;
        active = false;
        break;
      }
      int r = 0;  // 1 hit, 0 left the sub-level / no descend, -1 budget
      float sub_t = 0.0f, scale = 1.0f;
      int sub_axis = -1;
      if (mid) {  // 2x2x2 LoD byte: hit*2 - normal*0.2*eps (voxel.cuh:217)
        const unsigned int byte = (word >> 12) & 0xFFu;
        auto occ = [byte](int x, int y, int z) {
          const int lin = min(max(x + y * 2 + z * 4, 0), 7);
          return ((byte >> lin) & 1u) != 0u;
        };
        const float eps_byte = 0.2f * P.eps;
        scale = 4.0f;
        r = bm::sub_dda<2>((ox + ax.d * nd) * 2.0f - ntx * eps_byte,
                           (oy + ay.d * nd) * 2.0f - nty * eps_byte,
                           (oz + az.d * nd) * 2.0f - ntz * eps_byte, ax, ay,
                           az, occ, budget, sub_t, sub_axis);
      } else if (word & kLoadedBit) {  // 8^3 brick: hit*8 - normal*eps
        const int sc = min(max(px / P.sc + (py / P.sc) * P.sc_xy +
                                   (pz / P.sc) * P.sc_xy * P.sc_xy, 0),
                           P.num_sc - 1);
        const int* row =
            pool + static_cast<long long>(pool_base[sc] +
                                          static_cast<int>(word & 0xFFFu)) * 16;
        auto occ = [row](int x, int y, int z) {
          const int lin = min(max(x + y * 8 + z * 64, 0), 511);
          return ((static_cast<unsigned int>(row[lin >> 5]) >> (lin & 31)) &
                  1u) != 0u;
        };
        r = bm::sub_dda<8>((ox + ax.d * nd) * bszf - ntx * P.eps,
                           (oy + ay.d * nd) * bszf - nty * P.eps,
                           (oz + az.d * nd) * bszf - ntz * P.eps, ax, ay, az,
                           occ, budget, sub_t, sub_axis);
      } else if (word & kUnloadedBit) {  // resident nowhere: request it
        hit = request = true;
        t = nd * bszf;
        hnx = ntx; hny = nty; hnz = ntz;
        active = false;
        break;
      }
      if (r == 1) {
        hit = true;
        t = nd * bszf + sub_t * scale;
        if (sub_axis >= 0) {
          const float sf = bm::sel3(sub_axis, bm::sign_f(ax.d),
                                    bm::sign_f(ay.d), bm::sign_f(az.d));
          hnx = sub_axis == 0 ? -sf : 0.0f;
          hny = sub_axis == 1 ? -sf : 0.0f;
          hnz = sub_axis == 2 ? -sf : 0.0f;
        } else {
          hnx = ntx; hny = nty; hnz = ntz;
        }
        active = false;
        break;
      }
      if (r < 0) break;  // budget ran out inside the sub-level
    }
    if (!bm::top_step(word, occ0, ax, ay, az, P.cx, P.cy, P.cz, px, py, pz,
                      tx, ty, tz, axis0)) {
      active = false;  // left the grid: a miss
    }
  }

  const float tmin = tminn[i];
  hit_out[i] = hit;
  t_out[i] = hit ? t + tmin : 0.0f;
  normal_out[3 * i + 0] = hnx;
  normal_out[3 * i + 1] = hny;
  normal_out[3 * i + 2] = hnz;
  request_out[i] = request;
  request_pos[3 * i + 0] = request ? px : 0;
  request_pos[3 * i + 1] = request ? py : 0;
  request_pos[3 * i + 2] = request ? pz : 0;
  exhausted_out[i] = active;
  // Resume distance of an exhausted ray: entry t of the top cell it is in,
  // in world units along the original ray.
  float resume = 0.0f;
  if (active) {
    const float rc = axis0 >= 0 ? bm::sel3(axis0, tx, ty, tz) -
                                      bm::sel3(axis0, ax.td, ay.td, az.td)
                                : 0.0f;
    resume = fmaxf(rc * bszf + tmin, 0.0f);
  }
  resume_out[i] = resume;
  iters_out[i] = P.max_iters - budget;
}

}  // namespace

extern "C" int traverse_launch(
    int n, const float* clipped, const float* dirs, const float* entry_normal,
    const float* tminn, const unsigned char* ok, const int* index_volume,
    const int* pool_words, const int* pool_base, int cells_x, int cells_y,
    int cells_z, int sc_size, int sc_xy, int num_sc, int cam_x, int cam_y,
    int cam_z, int lod8, int lod2, int brick_size,
    float epsilon, int max_iters, unsigned char* hit, float* t,
    float* normal, unsigned char* request, int* request_pos,
    unsigned char* exhausted, float* resume_t, int* iters, void* stream) {
  const Params P{cells_x, cells_y, cells_z, sc_size, sc_xy, num_sc,
                 cam_x,   cam_y,   cam_z,   lod8,    lod2,  brick_size,
                 epsilon, max_iters};
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    traverse_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        P, n, clipped, dirs, entry_normal, tminn, ok, index_volume,
        pool_words, pool_base, hit, t, normal, request, request_pos,
        exhausted, resume_t, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
