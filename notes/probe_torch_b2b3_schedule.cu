// Probe copies of kernels B2 (traversal) and B3 (segment recorder) in their
// first designs: one CUDA thread per ray, in launch order, as
// brickmap_tpu_torch/csrc/traverse.cu and record.cu had them before the
// persistent-warp redesign.  The kernel bodies are verbatim; only the
// launch bounds take PROBE_MIN_BLOCKS (0: none, as shipped) and the
// launchers are renamed old_traverse_launch / old_record_launch.
//
// Built by notes/probe_torch_b2b3_schedule.py with the port's nvcc flags,
// once per PROBE_MIN_BLOCKS value.  The DDA building blocks below are
// brickmap_tpu_torch/csrc/dda.cuh of that time, with the integer step kept
// in Axis.

#include <cuda_runtime.h>

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

#ifndef PROBE_MIN_BLOCKS
#define PROBE_MIN_BLOCKS 0
#endif
#if PROBE_MIN_BLOCKS > 0
#define PROBE_BOUNDS __launch_bounds__(kThreads, PROBE_MIN_BLOCKS)
#else
#define PROBE_BOUNDS __launch_bounds__(kThreads)
#endif

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

__global__ void PROBE_BOUNDS
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

struct RParams {
  int cx, cy, cz;         // brick-grid extents
  int sc, sc_xy;          // superchunk edge in bricks, superchunks per xy row
  int k;                  // segments per ray
  int max_steps;          // top-level DDA steps per ray
};

__global__ void PROBE_BOUNDS
record_kernel(RParams P, int n, const float* __restrict__ o_cells,
              const float* __restrict__ dirs,
              const unsigned char* __restrict__ ok,
              const int* __restrict__ iv, const int* __restrict__ pool_base,
              int* __restrict__ cells_out, float* __restrict__ nd_out,
              int* __restrict__ ncode_out, int* __restrict__ slot_out,
              int* __restrict__ count_out,
              unsigned char* __restrict__ exhausted_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const bm::Axis ax = bm::make_axis(dirs[3 * i + 0]);
  const bm::Axis ay = bm::make_axis(dirs[3 * i + 1]);
  const bm::Axis az = bm::make_axis(dirs[3 * i + 2]);
  int px, py, pz;
  float tx, ty, tz;
  bm::axis_start(o_cells[3 * i + 0], ax, px, tx);
  bm::axis_start(o_cells[3 * i + 1], ay, py, ty);
  bm::axis_start(o_cells[3 * i + 2], az, pz, tz);
  bool alive = ok[i] && px >= 0 && px < P.cx && py >= 0 && py < P.cy &&
               pz >= 0 && pz < P.cz;

  const long long row = static_cast<long long>(i) * P.k;
  int count = 0;
  int axis0 = -1;  // axis of the face through which the current cell was
                   // entered (-1: the start cell)
  int budget = P.max_steps;
  while (alive) {
    if (budget == 0) break;  // exhausted: `alive` stays set
    --budget;
    const unsigned int word = static_cast<unsigned int>(
        iv[(pz * P.cy + py) * P.cx + px]);
    const bool occ0 = (word & kFlagBits) != 0u;
    if (occ0) {
      float nd = 0.0f;
      if (axis0 >= 0) {
        nd = bm::sel3(axis0, tx, ty, tz) -
             bm::sel3(axis0, ax.td, ay.td, az.td);
      }
      cells_out[row + count] = px | (py << 10) | (pz << 20);
      nd_out[row + count] = nd;
      ncode_out[row + count] = axis0;
      if (slot_out != nullptr) {
        const int sc = px / P.sc + (py / P.sc) * P.sc_xy +
                       (pz / P.sc) * P.sc_xy * P.sc_xy;
        slot_out[row + count] =
            (word & kLoadedBit) ? pool_base[sc] + static_cast<int>(word & 0xFFFu)
                                : -1;
      }
      if (++count >= P.k) {
        alive = false;
        break;
      }
    }

    // Step; from an empty cell with skip radius R >= 1 jump each axis by its
    // crossing count up to the first crossing that leaves the empty box.
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
    const float tlx = kx > 0 ? tx - ax.td : -bm::kBig;
    const float tly = ky > 0 ? ty - ay.td : -bm::kBig;
    const float tlz = kz > 0 ? tz - az.td : -bm::kBig;
    axis0 = tlx > tly ? (tlx > tlz ? 0 : 2) : (tly > tlz ? 1 : 2);
    if ((ax.d > 0.0f && px >= P.cx) || (ax.d < 0.0f && px < 0) ||
        (ay.d > 0.0f && py >= P.cy) || (ay.d < 0.0f && py < 0) ||
        (az.d > 0.0f && pz >= P.cz) || (az.d < 0.0f && pz < 0)) {
      alive = false;  // left the grid
    }
  }

  for (int k = count; k < P.k; ++k) {  // unused segments
    cells_out[row + k] = -1;
    nd_out[row + k] = 0.0f;
    ncode_out[row + k] = -1;
    if (slot_out != nullptr) slot_out[row + k] = -1;
  }
  count_out[i] = count;
  exhausted_out[i] = alive;
}

}  // namespace

extern "C" int old_traverse_launch(
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

extern "C" int old_record_launch(int n, int k, const float* o_cells,
                                 const float* dirs, const unsigned char* ok,
                                 const int* index_volume, const int* pool_base,
                                 int cells_x, int cells_y, int cells_z,
                                 int sc_size, int sc_xy, int max_steps,
                                 int* cells, float* nd, int* ncode, int* slot,
                                 int* count, unsigned char* exhausted,
                                 void* stream) {
  const RParams P{cells_x, cells_y, cells_z, sc_size, sc_xy, k, max_steps};
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    record_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        P, n, o_cells, dirs, ok, index_volume, pool_base, cells, nd, ncode,
        slot, count, exhausted);
  }
  return static_cast<int>(cudaGetLastError());
}
