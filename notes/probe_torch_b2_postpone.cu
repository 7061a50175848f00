// Probe build of kernel B2 (csrc/traverse.cu): the same traversal with its
// brick descends postponed until a warp can run several together, the
// design measured and not shipped (notes/probe_torch_b2.py, `--b2 P...`).
// Its launcher has csrc's signature (the device count and the cursor's
// scratch), and every output is bit-equal to the plain version
// brickmap_tpu_torch/ops/traverse.py::trace_rays (tests/
// test_torch_traverse_host.py builds it with g++ too).
//
// The idea: a warp of 32 neighbouring rays in launch order diverges at
// every occupied cell, where some lanes descend into a LoD byte or a brick
// while the others take top steps.  Here a lane that reaches a cell it must
// descend into holds it and takes no more top steps, while the warp steps
// its other lanes, until kHoldLanes lanes hold one or no lane is left
// stepping; then the holding lanes descend together (Aila and Laine's
// traversal with postponed leaf tests, HPG 2009, with a brick as the
// leaf), the byte and brick descends in one loop.  A holding ray's state
// does not change while it waits, so each ray's steps and budget
// decrements come in the plain version's order.  Every lane stays in the
// warp's loop until the warp is done, so that the votes are convergent.
//
// What it measured on an H100 (view 0's primaries, against csrc's 0.695
// ms): 0.80-0.97 ms; descend steps ran with ~11 lanes against the
// one-thread-a-ray walk's ~15, top steps with ~23 against ~20.
//
// The grid is at most the resident blocks (probe::resident_blocks); each warp
// takes the next 32 rays from a cursor in `ctl` until the count runs out,
// reading the count again at each fetch; the last block out resets the
// cursor.
//
// Build macros (the probe's --b2 P<spec>):
//   BM_B2_HOLD       lanes holding a descend that start one (0: only when
//                    every lane still walking holds one);
//   BM_B2_HOLD_BYTE  1: a LoD-byte descend is held like a brick descend;
//                    0: it runs at once, in the top step;
//   BM_B2_GRID       1: the resident grid above; 0: a block per 128 rows of
//                    the capacity, whose threads past the count write
//                    nothing;
//   BM_B2_BLOCKS_PER_SM  the resident grid's cap of blocks an SM.
// BM_B2_COUNT(kind, v) is the counting hook of notes/probe_torch_b2_count.cu,
// at points every lane of the warp reaches (kind 0: v = 1 for a lane that
// took a top step in this round; kind 1: v = the steps of a lane's
// descend); empty by default.

#include <cuda_runtime.h>

#include "traverse.cuh"
#include "probe_torch_b2_resident.cuh"

#ifndef BM_B2_HOLD
#define BM_B2_HOLD 16
#endif
#ifndef BM_B2_HOLD_BYTE
#define BM_B2_HOLD_BYTE 1
#endif
#ifndef BM_B2_GRID
#define BM_B2_GRID 1
#endif
#ifndef BM_B2_BLOCKS_PER_SM
#define BM_B2_BLOCKS_PER_SM 9
#endif
#ifndef BM_B2_COUNT
#define BM_B2_COUNT(kind, v)
#endif

namespace {

constexpr int kThreads = 128;
constexpr unsigned int kFullWarp = 0xffffffffu;
constexpr int kHoldLanes = BM_B2_HOLD;

// A lane's state in the warp's loop: its ray ended (or it has none), it
// takes top steps, or it holds a descend into a brick or a LoD byte.
enum Lane { kDone = 0, kStep, kHoldBrick, kHoldByte };
// The scratch's words: the cursor (rays handed out) and the blocks out.
enum Ctl { kCursor = 0, kExits };

__global__ void __launch_bounds__(kThreads)
traverse_kernel(bm::TraverseParams P, const int* __restrict__ count,
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
                float* __restrict__ resume_out, int* __restrict__ iters_out,
                int* __restrict__ ctl) {
#if BM_B2_GRID
  if (*count <= 0) return;
#endif
  const int lane = static_cast<int>(threadIdx.x) % 32;
  for (;;) {
#if BM_B2_GRID
    int first = 0;
    if (lane == 0) first = atomicAdd(ctl + kCursor, 32);
    first = __shfl_sync(kFullWarp, first, 0);
#else
    const int first = static_cast<int>(blockIdx.x) * kThreads +
                      static_cast<int>(threadIdx.x) - lane;
#endif
    const int n = *count;
    if (first >= n) break;
    // A lane past the count walks nothing and writes nothing; it reads the
    // tile's last ray so that every load stays in bounds.
    const bool mine = first + lane < n;
    const int i = mine ? first + lane : n - 1;

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
    bool active = mine && ok[i] && px >= 0 && px < P.cx && py >= 0 &&
                  py < P.cy && pz >= 0 && pz < P.cz;

    int budget = P.max_iters;
    int axis0 = -1;  // axis of the face through which the current top cell
                     // was entered (-1: the start cell)
    bool hit = false, request = false;
    float t = 0.0f, hnx = 0.0f, hny = 0.0f, hnz = 0.0f;
    int state = active ? kStep : kDone;
    unsigned int word = 0u;  // the current top cell's index word

    // Entry distance (cells) and face normal of the current top cell.
    auto entry = [&](float& nd, float& ntx, float& nty, float& ntz) {
      nd = 0.0f;
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
    };
    // The end of a descend that returned r (bm::sub_dda's 1 hit, 0 left
    // the sub-level, -1 budget spent; sub_t cells of the level, `scale`
    // voxels each, to the face of axis sub_axis): a hit, an exhausted ray
    // (`active` stays set) or the top step out of the cell.
    auto after_descend = [&](int r, float nd, float ntx, float nty,
                             float ntz, float sub_t, float scale,
                             int sub_axis) {
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
        state = kDone;
      } else if (r < 0) {
        state = kDone;  // exhausted inside the sub-level
      } else if (!bm::top_step(word, true, ax, ay, az, P.cx, P.cy, P.cz,
                               px, py, pz, tx, ty, tz, axis0)) {
        active = false;  // left the grid: a miss
        state = kDone;
      } else {
        state = kStep;
      }
    };

    for (;;) {
      // A round of top steps: each stepping lane takes one.
      BM_B2_COUNT(0, state == kStep && budget > 0 ? 1 : 0);
      if (state == kStep) {
        if (budget == 0) {
          state = kDone;  // exhausted: `active` stays set
        } else {
          --budget;
          // In bounds while active (the plain version clamps, to no effect).
          word = static_cast<unsigned int>(iv[(pz * P.cy + py) * P.cx + px]);
          const bool occ0 = (word & bm::kFlagBits) != 0u;
          if (occ0) {
            const int ddx = P.cam_x - px, ddy = P.cam_y - py,
                      ddz = P.cam_z - pz;
            const int d2 = ddx * ddx + ddy * ddy + ddz * ddz;
            const bool far = d2 > P.lod8;
            const bool mid = !far && d2 > P.lod2;
            if (far || (!mid && !(word & bm::kLoadedBit) &&
                        (word & bm::kUnloadedBit))) {
              // A brick-granular hit, or a hit at the face of a brick
              // resident nowhere, with a request for it.
              float nd, ntx, nty, ntz;
              entry(nd, ntx, nty, ntz);
              hit = true;
              request = !far;
              t = nd * bszf;
              hnx = ntx; hny = nty; hnz = ntz;
              active = false;
              state = kDone;
            } else if (mid) {
#if BM_B2_HOLD_BYTE
              state = kHoldByte;
#else
              // The 2x2x2 LoD byte at once, as a descend below would.
              float nd, ntx, nty, ntz;
              entry(nd, ntx, nty, ntz);
              const unsigned int byte = (word >> 12) & 0xFFu;
              auto occ = [byte](int x, int y, int z) {
                const int lin = min(max(x + y * 2 + z * 4, 0), 7);
                return ((byte >> lin) & 1u) != 0u;
              };
              const float eps_byte = 0.2f * P.eps;
              float sub_t = 0.0f;
              int sub_axis = -1;
              const int r = bm::sub_dda<2>(
                  (ox + ax.d * nd) * 2.0f - ntx * eps_byte,
                  (oy + ay.d * nd) * 2.0f - nty * eps_byte,
                  (oz + az.d * nd) * 2.0f - ntz * eps_byte, ax, ay, az, occ,
                  budget, sub_t, sub_axis);
              if (r != 0) {  // r == 0: the top step below
                after_descend(r, nd, ntx, nty, ntz, sub_t, 4.0f, sub_axis);
              }
#endif
            } else if (word & bm::kLoadedBit) {
              state = kHoldBrick;
            }
          }
          if (state == kStep &&
              !bm::top_step(word, occ0, ax, ay, az, P.cx, P.cy, P.cz, px, py,
                            pz, tx, ty, tz, axis0)) {
            active = false;  // left the grid: a miss
            state = kDone;
          }
        }
      }
      const unsigned int hold = __ballot_sync(kFullWarp, state >= kHoldBrick);
      const unsigned int step = __ballot_sync(kFullWarp, state == kStep);
      if ((hold | step) == 0u) break;
      if (hold == 0u ||
          (step != 0u && (kHoldLanes <= 0 || __popc(hold) < kHoldLanes))) {
        continue;
      }
      // The holding lanes descend together.
      const int before = budget;
      if (state >= kHoldBrick) {
        float nd, ntx, nty, ntz;
        entry(nd, ntx, nty, ntz);
        const bool byte_level = state == kHoldByte;
        // A LoD byte: 2x2x2 cells from hit*2 - normal*0.2*eps
        // (voxel.cuh:217), a hit 4 voxels a cell; a brick: 8x8x8 voxels
        // from hit*8 - normal*eps, its row of 16 words in the pool.
        const int ext = byte_level ? 2 : 8;
        const float lscale = byte_level ? 2.0f : bszf;
        const float leps = byte_level ? 0.2f * P.eps : P.eps;
        const unsigned int byte = (word >> 12) & 0xFFu;
        const int* row = pool;
        if (!byte_level) {
          const int sc = min(max(px / P.sc + (py / P.sc) * P.sc_xy +
                                     (pz / P.sc) * P.sc_xy * P.sc_xy, 0),
                             P.num_sc - 1);
          row = pool + static_cast<long long>(
                           pool_base[sc] + static_cast<int>(word & 0xFFFu)) *
                           16;
        }
        // bm::sub_dda<2> or <8> in one loop.
        int qx, qy, qz;
        float sx, sy, sz;
        bm::axis_start((ox + ax.d * nd) * lscale - ntx * leps, ax, qx, sx);
        bm::axis_start((oy + ay.d * nd) * lscale - nty * leps, ay, qy, sy);
        bm::axis_start((oz + az.d * nd) * lscale - ntz * leps, az, qz, sz);
        // C's % truncates, like the reference's trunc-mod of the nudged
        // origin.
        qx = byte_level ? qx % 2 : qx % 8;
        qy = byte_level ? qy % 2 : qy % 8;
        qz = byte_level ? qz % 2 : qz % 8;
        const int outx = ax.d > 0.0f ? ext : -1;
        const int outy = ay.d > 0.0f ? ext : -1;
        const int outz = az.d > 0.0f ? ext : -1;
        const int last = ext * ext * ext - 1;
        int a = -1, r = -1;
        float sub_t = 0.0f;
        while (budget > 0) {
          --budget;
          const int lin = min(max(qx + qy * ext + qz * ext * ext, 0), last);
          const unsigned int bits =
              byte_level ? byte : static_cast<unsigned int>(row[lin >> 5]);
          if (((bits >> (lin & 31)) & 1u) != 0u) {
            sub_t = a >= 0 ? bm::sel3(a, sx, sy, sz) -
                                 bm::sel3(a, ax.td, ay.td, az.td)
                           : 0.0f;
            r = 1;
            break;
          }
          a = bm::sel_axis(sx, sy, sz);
          int p, out;
          if (a == 0) {
            qx += bm::step_of(ax); p = qx; out = outx; sx = sx + ax.td;
          } else if (a == 1) {
            qy += bm::step_of(ay); p = qy; out = outy; sy = sy + ay.td;
          } else {
            qz += bm::step_of(az); p = qz; out = outz; sz = sz + az.td;
          }
          if (p == out) {
            r = 0;
            break;
          }
        }
        after_descend(r, nd, ntx, nty, ntz, sub_t,
                      byte_level ? 4.0f : 1.0f, a);
      }
      BM_B2_COUNT(1, before - budget);
    }

    if (mine) {
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
      resume_out[i] = bm::resume_distance(active, axis0, tx, ty, tz, ax, ay,
                                          az, bszf, tmin);
      iters_out[i] = P.max_iters - budget;
    }
#if !BM_B2_GRID
    break;
#endif
  }
#if BM_B2_GRID
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(ctl + kExits, 1) == static_cast<int>(gridDim.x) - 1) {
      ctl[kCursor] = ctl[kExits] = 0;
    }
  }
#endif
}

}  // namespace

extern "C" int traverse_launch(
    int n, const int* count, const float* clipped, const float* dirs,
    const float* entry_normal, const float* tminn, const unsigned char* ok,
    const int* index_volume, const int* pool_words, const int* pool_base,
    int cells_x, int cells_y, int cells_z, int sc_size, int sc_xy,
    int num_sc, int cam_x, int cam_y, int cam_z, int lod8, int lod2,
    int brick_size, float epsilon, int max_iters, unsigned char* hit,
    float* t, float* normal, unsigned char* request, int* request_pos,
    unsigned char* exhausted, float* resume_t, int* iters, int* scratch,
    void* stream) {
  static int resident[64] = {};
  const bm::TraverseParams P{cells_x, cells_y, cells_z, sc_size, sc_xy,
                             num_sc,  cam_x,   cam_y,   cam_z,   lod8,
                             lod2,    brick_size, epsilon, max_iters};
  if (n > 0) {
    const int need = (n + kThreads - 1) / kThreads;
#if BM_B2_GRID
    const int blocks = min(need, probe::resident_blocks(traverse_kernel,
                                                     kThreads, resident,
                                                     BM_B2_BLOCKS_PER_SM));
#else
    const int blocks = need;
    (void)resident;
#endif
    traverse_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        P, count, clipped, dirs, entry_normal, tminn, ok, index_volume,
        pool_words, pool_base, hit, t, normal, request, request_pos,
        exhausted, resume_t, iters, scratch);
  }
  return static_cast<int>(cudaGetLastError());
}
