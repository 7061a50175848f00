// Probe variants of kernel B2 (brickmap_tpu_torch/csrc/traverse.cu), for
// notes/probe_torch_b2b3_schedule.py --variants: the same per-ray code as
// the kernel, built with
//   PROBE_STRUCT      1: the ray, scene and output pointers passed in
//                     structs whose members are __restrict__ (nvcc does not
//                     carry that qualifier through a struct member);
//                     0: as separate __restrict__ kernel arguments;
//   PROBE_LDG         1: the scene's reads (index word, pool_base, brick
//                     row) through __ldg, the read-only path, explicitly;
//   PROBE_MIN_BLOCKS  the launch bounds' minimum blocks an SM (0: none);
//   PROBE_EARLY_OUT   1: a ray that hits writes all its outputs where the
//                     hit is found and returns, so that no hit state lives
//                     to the end of the kernel;
//   PROBE_LAZY_NORMAL 1: the entry normal read from memory in the start
//                     cell, where it is used, not held in 3 registers
//                     through the walk.
// The launcher has traverse_launch's C signature.

#include <cuda_runtime.h>

#include "dda.cuh"

#ifndef PROBE_STRUCT
#define PROBE_STRUCT 0
#endif
#ifndef PROBE_LDG
#define PROBE_LDG 0
#endif
#ifndef PROBE_MIN_BLOCKS
#define PROBE_MIN_BLOCKS 0
#endif
#ifndef PROBE_EARLY_OUT
#define PROBE_EARLY_OUT 0
#endif
#ifndef PROBE_LAZY_NORMAL
#define PROBE_LAZY_NORMAL 0
#endif

#if PROBE_LDG
#define SCENE_LD(p) __ldg(&(p))
#else
#define SCENE_LD(p) (p)
#endif

#if PROBE_MIN_BLOCKS > 0
#define PROBE_BOUNDS __launch_bounds__(128, PROBE_MIN_BLOCKS)
#else
#define PROBE_BOUNDS __launch_bounds__(128)
#endif

namespace {

constexpr int kThreads = 128;
constexpr unsigned int kFlagBits = 0xE0000000u;
constexpr unsigned int kLoadedBit = 0x80000000u;
constexpr unsigned int kUnloadedBit = 0x40000000u;

struct Params {
  int cx, cy, cz;
  int sc, sc_xy, num_sc;
  int cam_x, cam_y, cam_z;
  int lod8, lod2;
  int bsz;
  float eps;
  int max_iters;
};

#if PROBE_STRUCT
struct Rays {
  const float* __restrict__ clipped;
  const float* __restrict__ dirs;
  const float* __restrict__ entry_normal;
  const float* __restrict__ tminn;
  const unsigned char* __restrict__ ok;
};
struct Scene {
  const int* __restrict__ iv;
  const int* __restrict__ pool;
  const int* __restrict__ pool_base;
};
struct Out {
  unsigned char* __restrict__ hit;
  float* __restrict__ t;
  float* __restrict__ normal;
  unsigned char* __restrict__ request;
  int* __restrict__ request_pos;
  unsigned char* __restrict__ exhausted;
  float* __restrict__ resume;
  int* __restrict__ iters;
};
#define clipped R.clipped
#define dirs R.dirs
#define entry_normal R.entry_normal
#define tminn R.tminn
#define ok R.ok
#define iv S.iv
#define pool S.pool
#define pool_base S.pool_base
#define hit_out O.hit
#define t_out O.t
#define normal_out O.normal
#define request_out O.request
#define request_pos O.request_pos
#define exhausted_out O.exhausted
#define resume_out O.resume
#define iters_out O.iters
#endif

__global__ void PROBE_BOUNDS
#if PROBE_STRUCT
traverse_kernel(Params P, int n, Rays R, Scene S, Out O) {
#else
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
#endif
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float bszf = static_cast<float>(P.bsz);
  const bm::Axis ax = bm::make_axis(dirs[3 * i + 0]);
  const bm::Axis ay = bm::make_axis(dirs[3 * i + 1]);
  const bm::Axis az = bm::make_axis(dirs[3 * i + 2]);
  const float ox = clipped[3 * i + 0] / bszf;
  const float oy = clipped[3 * i + 1] / bszf;
  const float oz = clipped[3 * i + 2] / bszf;
#if !PROBE_LAZY_NORMAL
  const float enx = entry_normal[3 * i + 0];
  const float eny = entry_normal[3 * i + 1];
  const float enz = entry_normal[3 * i + 2];
#endif

  int px, py, pz;
  float tx, ty, tz;
  bm::axis_start(ox, ax, px, tx);
  bm::axis_start(oy, ay, py, ty);
  bm::axis_start(oz, az, pz, tz);
  bool active = ok[i] && px >= 0 && px < P.cx && py >= 0 && py < P.cy &&
                pz >= 0 && pz < P.cz;

  int budget = P.max_iters;
  int axis0 = -1;
  bool hit = false, request = false;
  float t = 0.0f, hnx = 0.0f, hny = 0.0f, hnz = 0.0f;
#if PROBE_EARLY_OUT
  // All outputs of a ray that hits at distance th (cells x brick, before
  // tmin) with normal n.
  auto hit_exit = [&](float th, float nx, float ny, float nz, bool req) {
    hit_out[i] = true;
    t_out[i] = th + tminn[i];
    normal_out[3 * i + 0] = nx;
    normal_out[3 * i + 1] = ny;
    normal_out[3 * i + 2] = nz;
    request_out[i] = req;
    request_pos[3 * i + 0] = req ? px : 0;
    request_pos[3 * i + 1] = req ? py : 0;
    request_pos[3 * i + 2] = req ? pz : 0;
    exhausted_out[i] = false;
    resume_out[i] = 0.0f;
    iters_out[i] = P.max_iters - budget;
  };
#define HIT_EXIT(th, nx, ny, nz, req) \
  do {                                \
    hit_exit(th, nx, ny, nz, req);    \
    return;                           \
  } while (0)
#else
#define HIT_EXIT(th, nx, ny, nz, req) \
  do {                                \
    hit = true;                       \
    request = req;                    \
    t = th;                           \
    hnx = nx; hny = ny; hnz = nz;     \
    active = false;                   \
  } while (0)
#endif

  while (active) {
    if (budget == 0) break;
    --budget;
    const unsigned int word =
        static_cast<unsigned int>(SCENE_LD(iv[(pz * P.cy + py) * P.cx + px]));
    const bool occ0 = (word & kFlagBits) != 0u;
    if (occ0) {
      float nd = 0.0f, ntx, nty, ntz;
      if (axis0 >= 0) {
        nd = bm::sel3(axis0, tx, ty, tz) -
             bm::sel3(axis0, ax.td, ay.td, az.td);
        const float sf = bm::sel3(axis0, bm::sign_f(ax.d), bm::sign_f(ay.d),
                                  bm::sign_f(az.d));
        ntx = axis0 == 0 ? -sf : 0.0f;
        nty = axis0 == 1 ? -sf : 0.0f;
        ntz = axis0 == 2 ? -sf : 0.0f;
      } else {
#if PROBE_LAZY_NORMAL
        ntx = entry_normal[3 * i + 0];
        nty = entry_normal[3 * i + 1];
        ntz = entry_normal[3 * i + 2];
#else
        ntx = enx; nty = eny; ntz = enz;
#endif
      }
      const int ddx = P.cam_x - px, ddy = P.cam_y - py, ddz = P.cam_z - pz;
      const int d2 = ddx * ddx + ddy * ddy + ddz * ddz;
      const bool far = d2 > P.lod8;
      const bool mid = !far && d2 > P.lod2;
      if (far) {
        HIT_EXIT(nd * bszf, ntx, nty, ntz, false);
        break;
      }
      int r = 0;
      float sub_t = 0.0f, scale = 1.0f;
      int sub_axis = -1;
      if (mid) {
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
      } else if (word & kLoadedBit) {
        const int sc = min(max(px / P.sc + (py / P.sc) * P.sc_xy +
                                   (pz / P.sc) * P.sc_xy * P.sc_xy, 0),
                           P.num_sc - 1);
        const int* row =
            pool + static_cast<long long>(SCENE_LD(pool_base[sc]) +
                                          static_cast<int>(word & 0xFFFu)) * 16;
        auto occ = [row](int x, int y, int z) {
          const int lin = min(max(x + y * 8 + z * 64, 0), 511);
          return ((static_cast<unsigned int>(SCENE_LD(row[lin >> 5])) >>
                   (lin & 31)) & 1u) != 0u;
        };
        r = bm::sub_dda<8>((ox + ax.d * nd) * bszf - ntx * P.eps,
                           (oy + ay.d * nd) * bszf - nty * P.eps,
                           (oz + az.d * nd) * bszf - ntz * P.eps, ax, ay, az,
                           occ, budget, sub_t, sub_axis);
      } else if (word & kUnloadedBit) {
        HIT_EXIT(nd * bszf, ntx, nty, ntz, true);
        break;
      }
      if (r == 1) {
        if (sub_axis >= 0) {
          const float sf = bm::sel3(sub_axis, bm::sign_f(ax.d),
                                    bm::sign_f(ay.d), bm::sign_f(az.d));
          HIT_EXIT(nd * bszf + sub_t * scale, sub_axis == 0 ? -sf : 0.0f,
                   sub_axis == 1 ? -sf : 0.0f, sub_axis == 2 ? -sf : 0.0f,
                   false);
        } else {
          HIT_EXIT(nd * bszf + sub_t * scale, ntx, nty, ntz, false);
        }
        break;
      }
      if (r < 0) break;
    }
    if (!bm::top_step(word, occ0, ax, ay, az, P.cx, P.cy, P.cz, px, py, pz,
                      tx, ty, tz, axis0)) {
      active = false;
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

#undef HIT_EXIT
#if PROBE_STRUCT
#undef clipped
#undef dirs
#undef entry_normal
#undef tminn
#undef ok
#undef iv
#undef pool
#undef pool_base
#undef hit_out
#undef t_out
#undef normal_out
#undef request_out
#undef request_pos
#undef exhausted_out
#undef resume_out
#undef iters_out
#endif

}  // namespace

extern "C" int variant_traverse_launch(
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
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#if PROBE_STRUCT
    const Rays R{clipped, dirs, entry_normal, tminn, ok};
    const Scene S{index_volume, pool_words, pool_base};
    const Out O{hit, t, normal, request, request_pos, exhausted, resume_t,
                iters};
    traverse_kernel<<<blocks, kThreads, 0, s>>>(P, n, R, S, O);
#else
    traverse_kernel<<<blocks, kThreads, 0, s>>>(
        P, n, clipped, dirs, entry_normal, tminn, ok, index_volume,
        pool_words, pool_base, hit, t, normal, request, request_pos,
        exhausted, resume_t, iters);
#endif
  }
  return static_cast<int>(cudaGetLastError());
}
