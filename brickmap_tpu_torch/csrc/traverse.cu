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
// What bounds it on an H100: dependent loads.  Each top step waits on one
// 4-byte index word whose address depends on the previous step, and each
// brick descend on one 64-byte brick row (read word by word through L1 as
// the sub-DDA walks it).  The index volume of the 4096^2 x 512 world is 64 MB
// and the pool 554 MB, beyond the 50 MB L2, so the latency of these loads,
// not their bandwidth, sets the pace unless enough rays are in flight;
// empty-space skipping cuts the number of top steps.  Rays of one warp
// diverge in step count; the warp runs until its longest ray ends.
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
  const float enx = entry_normal[3 * i + 0];
  const float eny = entry_normal[3 * i + 1];
  const float enz = entry_normal[3 * i + 2];
  const float tmin = tminn[i];
  const float eps_byte = 0.2f * P.eps;

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
  int rqx = 0, rqy = 0, rqz = 0;

  while (active) {
    if (budget == 0) break;  // exhausted: `active` stays set
    --budget;
    // In bounds while active; clamped as the plain version does.
    const int cell = (min(max(pz, 0), P.cz - 1) * P.cy +
                      min(max(py, 0), P.cy - 1)) * P.cx +
                     min(max(px, 0), P.cx - 1);
    const unsigned int word = static_cast<unsigned int>(iv[cell]);

    // Entry distance (cells) and face normal of the current top cell.
    float nd = 0.0f, ntx = enx, nty = eny, ntz = enz;
    if (axis0 >= 0) {
      nd = bm::sel3(axis0, tx, ty, tz) - bm::sel3(axis0, ax.td, ay.td, az.td);
      const float sf = bm::sel3(axis0, bm::sign_f(ax.d), bm::sign_f(ay.d),
                                bm::sign_f(az.d));
      ntx = axis0 == 0 ? -sf : 0.0f;
      nty = axis0 == 1 ? -sf : 0.0f;
      ntz = axis0 == 2 ? -sf : 0.0f;
    }

    const bool occ0 = (word & kFlagBits) != 0u;
    if (occ0) {
      const int ddx = P.cam_x - px, ddy = P.cam_y - py, ddz = P.cam_z - pz;
      const int d2 = ddx * ddx + ddy * ddy + ddz * ddz;
      const bool far = d2 > P.lod8;
      const bool mid = !far && d2 > P.lod2;
      if (far) {  // brick-granular hit
        hit = true;
        t = nd * bszf + tmin;
        hnx = ntx; hny = nty; hnz = ntz;
        active = false;
        break;
      }
      int r = 0;          // 1 hit, 0 left the sub-level / no descend, -1 budget
      float sub_t = 0.0f, scale = 1.0f;
      int sub_axis = -1;
      if (mid) {  // 2x2x2 LoD byte: hit*2 - normal*0.2*eps (voxel.cuh:217)
        const unsigned int byte = (word >> 12) & 0xFFu;
        auto occ = [byte](int x, int y, int z) {
          const int lin = min(max(x + y * 2 + z * 4, 0), 7);
          return ((byte >> lin) & 1u) != 0u;
        };
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
        t = nd * bszf + tmin;
        hnx = ntx; hny = nty; hnz = ntz;
        rqx = px; rqy = py; rqz = pz;
        active = false;
        break;
      }
      if (r == 1) {
        hit = true;
        t = nd * bszf + sub_t * scale + tmin;
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

    // Top step.  From an empty cell with skip radius R >= 1 every cell
    // within L-inf distance R is empty: jump each axis by its crossing count
    // up to the first crossing that leaves that box.
    const int skip_r = max(static_cast<int>((word >> 20) & 0x1FFu) - 1, 0);
    const int a1 = bm::sel_axis(tx, ty, tz);
    int kx = a1 == 0, ky = a1 == 1, kz = a1 == 2;
    if (!occ0 && skip_r >= 1) {
      const float rf = static_cast<float>(skip_r);
      const float t_exit =
          fminf(fminf(ax.d != 0.0f ? tx + rf * ax.td : bm::kBig,
                      ay.d != 0.0f ? ty + rf * ay.td : bm::kBig),
                az.d != 0.0f ? tz + rf * az.td : bm::kBig);
      auto k_axis = [&](const bm::Axis& a, float ta) {
        if (a.d == 0.0f) return 0;
        const int k = static_cast<int>(
                          floorf((t_exit - ta) / (a.td == 0.0f ? 1.0f : a.td))) +
                      1;
        return min(max(k, 0), skip_r + 1);
      };
      const int jx = k_axis(ax, tx), jy = k_axis(ay, ty), jz = k_axis(az, tz);
      if (jx + jy + jz != 0) {  // a degenerate jump falls back to one step
        kx = jx; ky = jy; kz = jz;
      }
    }
    px += ax.step * kx;
    py += ay.step * ky;
    pz += az.step * kz;
    tx = tx + static_cast<float>(kx) * ax.td;
    ty = ty + static_cast<float>(ky) * ay.td;
    tz = tz + static_cast<float>(kz) * az.td;
    // Entry face of the new cell: the latest crossing among stepped axes.
    const float tlx = kx > 0 ? tx - ax.td : -bm::kBig;
    const float tly = ky > 0 ? ty - ay.td : -bm::kBig;
    const float tlz = kz > 0 ? tz - az.td : -bm::kBig;
    axis0 = tlx > tly ? (tlx > tlz ? 0 : 2) : (tly > tlz ? 1 : 2);
    if ((ax.d > 0.0f && px >= P.cx) || (ax.d < 0.0f && px < 0) ||
        (ay.d > 0.0f && py >= P.cy) || (ay.d < 0.0f && py < 0) ||
        (az.d > 0.0f && pz >= P.cz) || (az.d < 0.0f && pz < 0)) {
      active = false;  // left the grid: a miss
    }
  }

  hit_out[i] = hit;
  t_out[i] = t;
  normal_out[3 * i + 0] = hnx;
  normal_out[3 * i + 1] = hny;
  normal_out[3 * i + 2] = hnz;
  request_out[i] = request;
  request_pos[3 * i + 0] = rqx;
  request_pos[3 * i + 1] = rqy;
  request_pos[3 * i + 2] = rqz;
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
