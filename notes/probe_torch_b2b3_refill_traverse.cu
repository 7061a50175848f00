// Probe kernel: B2 on persistent warps that refill finished lanes from a
// global counter, measured by notes/probe_torch_b2b3_schedule.py against
// the first design (one thread per ray) and the shipped kernel
// (brickmap_tpu_torch/csrc/traverse.cu).  It computes what the shipped
// kernel computes, bit for bit; only the schedule differs.
//
// The grid holds only the blocks that fit resident; each warp takes rays
// from the global counter `next` in batches of kBatch (one atomicAdd a
// batch) and, whenever kRefill of its lanes have finished, starts the next
// rays of its batch in those lanes (bm::refill).  One loop iteration is one
// top-level step; a descend into the LoD byte or the brick runs to its end
// inside the iteration.  A lane writes its ray's outputs when the ray ends.
// With kCount the build also sums, per warp iteration, the most steps any
// lane took (steps[0]) and the lanes' steps (steps[1]).
//
// Built with the port's nvcc flags, -I brickmap_tpu_torch/csrc and the
// macros BM_TRAVERSE_REFILL, BM_TRAVERSE_MIN_BLOCKS and PROBE_BATCH.

#include <cuda_runtime.h>

#include "dda.cuh"

namespace bm {

// Persistent warps that refill finished lanes (Aila & Laine, "Understanding
// the Efficiency of Ray Traversal on GPUs", HPG 2009): a launch holds only
// as many blocks as fit resident, and each warp takes new rays as its lanes
// finish, so a warp no longer runs until the longest of 32 rays fixed at
// launch ends.
//
// Called by all 32 lanes of a warp, each with its `ray` (< 0: idle), and
// the warp-uniform range [bnext, bend) of ray indices the warp has taken
// from the global counter `next` and not yet started.  When at least
// `refill_at` lanes are idle (or all are), the idle lanes start the next
// rays of that range in lane order; an empty range is first refilled with
// the next `batch` indices by one atomicAdd.  Once the counter has passed n
// the range stays empty.  Returns true in a lane that took a new ray.
constexpr unsigned int kFullWarp = 0xFFFFFFFFu;

__device__ __forceinline__ bool refill(int& ray, int& bnext, int& bend,
                                       int* __restrict__ next, int n,
                                       int refill_at, int batch) {
  const unsigned int idle = __ballot_sync(kFullWarp, ray < 0);
  const int n_idle = __popc(idle);
  if (n_idle == 0 || (n_idle < refill_at && idle != kFullWarp)) return false;
  if (bnext >= bend) {
    if (bend >= n) return false;  // drained
    int base = 0;
    if ((threadIdx.x & 31u) == 0u) base = atomicAdd(next, batch);
    bnext = __shfl_sync(kFullWarp, base, 0);
    bend = bnext < n ? min(bnext + batch, n) : n;
    if (bnext >= bend) return false;
  }
  const int take = min(n_idle, bend - bnext);
  const int rank = __popc(idle & ((1u << (threadIdx.x & 31u)) - 1u));
  const bool took = ray < 0 && rank < take;
  if (took) ray = bnext + rank;
  bnext += take;
  return took;
}

}  // namespace bm


// The probe builds this file with its values through these macros.
#ifndef BM_TRAVERSE_REFILL
#define BM_TRAVERSE_REFILL 8
#endif
#ifndef BM_TRAVERSE_MIN_BLOCKS
#define BM_TRAVERSE_MIN_BLOCKS 12
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kRefill = BM_TRAVERSE_REFILL;
#ifndef PROBE_BATCH
#define PROBE_BATCH 32
#endif
constexpr int kBatch = PROBE_BATCH;  // rays a warp takes from the counter at once
constexpr int kMinBlocks = BM_TRAVERSE_MIN_BLOCKS;
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

// kCount: also sum, over the warps' iterations, the most steps any lane
// took in the iteration (steps[0]) and the lanes' steps (steps[1]).
template <bool kCount>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
traverse_kernel(Params P, int n, int* __restrict__ next,
                unsigned long long* __restrict__ steps,
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
  const float bszf = static_cast<float>(P.bsz);
  const float eps_byte = 0.2f * P.eps;
  int ray = -1;             // this lane's ray; < 0: idle
  int bnext = 0, bend = 0;  // the warp's rays not yet started
  bm::Axis ax, ay, az;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f;  // clipped origin in cells
  int px = 0, py = 0, pz = 0;
  float tx = 0.0f, ty = 0.0f, tz = 0.0f;
  int budget = 0;
  int axis0 = -1;  // axis of the face through which the current top cell
                   // was entered (-1: the start cell)
  bool active = false;
  unsigned int warp_steps = 0, lane_steps = 0;

  for (;;) {
    if (bm::refill(ray, bnext, bend, next, n, kRefill, kBatch)) {
      ax = bm::make_axis(dirs[3 * ray + 0]);
      ay = bm::make_axis(dirs[3 * ray + 1]);
      az = bm::make_axis(dirs[3 * ray + 2]);
      ox = clipped[3 * ray + 0] / bszf;
      oy = clipped[3 * ray + 1] / bszf;
      oz = clipped[3 * ray + 2] / bszf;
      bm::axis_start(ox, ax, px, tx);
      bm::axis_start(oy, ay, py, ty);
      bm::axis_start(oz, az, pz, tz);
      active = ok[ray] && px >= 0 && px < P.cx && py >= 0 && py < P.cy &&
               pz >= 0 && pz < P.cz;
      budget = P.max_iters;
      axis0 = -1;
    }
    if (__ballot_sync(bm::kFullWarp, ray >= 0) == 0u) break;

    int spent = 0;
    if (ray >= 0) {
      bool hit = false, request = false;
      float t = 0.0f, hnx = 0.0f, hny = 0.0f, hnz = 0.0f;
      if (active && budget > 0) {
        const int budget0 = budget;
        --budget;
        // In bounds while active; clamped as the plain version does.
        const int cell = (min(max(pz, 0), P.cz - 1) * P.cy +
                          min(max(py, 0), P.cy - 1)) * P.cx +
                         min(max(px, 0), P.cx - 1);
        const unsigned int word = static_cast<unsigned int>(iv[cell]);
        const bool occ0 = (word & kFlagBits) != 0u;
        bool stop = false;  // ended here, or spent the budget in a descend
        if (occ0) {
          // Entry distance (cells) and face normal of the current top cell.
          float nd = 0.0f, ntx, nty, ntz;
          if (axis0 >= 0) {
            nd = bm::sel3(axis0, tx, ty, tz) -
                 bm::sel3(axis0, ax.td, ay.td, az.td);
            const float sf = bm::sel3(axis0, bm::sign_f(ax.d),
                                      bm::sign_f(ay.d), bm::sign_f(az.d));
            ntx = axis0 == 0 ? -sf : 0.0f;
            nty = axis0 == 1 ? -sf : 0.0f;
            ntz = axis0 == 2 ? -sf : 0.0f;
          } else {
            ntx = entry_normal[3 * ray + 0];
            nty = entry_normal[3 * ray + 1];
            ntz = entry_normal[3 * ray + 2];
          }
          const int ddx = P.cam_x - px, ddy = P.cam_y - py,
                    ddz = P.cam_z - pz;
          const int d2 = ddx * ddx + ddy * ddy + ddz * ddz;
          const bool far = d2 > P.lod8;
          const bool mid = !far && d2 > P.lod2;
          int r = 0;  // 1 hit, 0 left the sub-level / no descend, -1 budget
          float sub_t = 0.0f, scale = 1.0f;
          int sub_axis = -1;
          if (far) {  // brick-granular hit
            hit = true;
            t = nd * bszf;
            hnx = ntx; hny = nty; hnz = ntz;
            stop = true;
          } else if (mid) {  // 2x2x2 LoD byte: hit*2 - normal*0.2*eps
            const unsigned int byte = (word >> 12) & 0xFFu;
            auto occ = [byte](int x, int y, int z) {
              const int lin = min(max(x + y * 2 + z * 4, 0), 7);
              return ((byte >> lin) & 1u) != 0u;
            };
            scale = 4.0f;
            r = bm::sub_dda<2>((ox + ax.d * nd) * 2.0f - ntx * eps_byte,
                               (oy + ay.d * nd) * 2.0f - nty * eps_byte,
                               (oz + az.d * nd) * 2.0f - ntz * eps_byte, ax,
                               ay, az, occ, budget, sub_t, sub_axis);
          } else if (word & kLoadedBit) {  // 8^3 brick: hit*8 - normal*eps
            const int sc = min(max(px / P.sc + (py / P.sc) * P.sc_xy +
                                       (pz / P.sc) * P.sc_xy * P.sc_xy,
                                   0),
                               P.num_sc - 1);
            const int* row =
                pool + static_cast<long long>(
                           pool_base[sc] + static_cast<int>(word & 0xFFFu)) *
                           16;
            auto occ = [row](int x, int y, int z) {
              const int lin = min(max(x + y * 8 + z * 64, 0), 511);
              return ((static_cast<unsigned int>(row[lin >> 5]) >>
                       (lin & 31)) & 1u) != 0u;
            };
            r = bm::sub_dda<8>((ox + ax.d * nd) * bszf - ntx * P.eps,
                               (oy + ay.d * nd) * bszf - nty * P.eps,
                               (oz + az.d * nd) * bszf - ntz * P.eps, ax, ay,
                               az, occ, budget, sub_t, sub_axis);
          } else if (word & kUnloadedBit) {  // resident nowhere: request it
            hit = request = true;
            t = nd * bszf;
            hnx = ntx; hny = nty; hnz = ntz;
            stop = true;
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
            stop = true;
          }
          if (hit) active = false;
          stop = stop || r < 0;  // r < 0: the budget ran out in the descend
        }
        if (!stop && !bm::top_step(word, occ0, ax, ay, az, P.cx, P.cy, P.cz,
                                   px, py, pz, tx, ty, tz, axis0)) {
          active = false;  // left the grid: a miss
        }
        spent = budget0 - budget;
      }

      if (!active || budget == 0) {  // the ray ended: write its outputs
        const int i = ray;
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
        // Resume distance of an exhausted ray: entry t of the top cell it
        // is in, in world units along the original ray.
        float resume = 0.0f;
        if (active) {
          const float rc = axis0 >= 0 ? bm::sel3(axis0, tx, ty, tz) -
                                            bm::sel3(axis0, ax.td, ay.td,
                                                     az.td)
                                      : 0.0f;
          resume = fmaxf(rc * bszf + tmin, 0.0f);
        }
        resume_out[i] = resume;
        iters_out[i] = P.max_iters - budget;
        ray = -1;
      }
    }
    if (kCount) {
      warp_steps += static_cast<unsigned int>(
          __reduce_max_sync(bm::kFullWarp, spent));
      lane_steps += static_cast<unsigned int>(spent);
    }
  }
  if (kCount) {
    lane_steps = __reduce_add_sync(bm::kFullWarp, lane_steps);
    if ((threadIdx.x & 31u) == 0u) {
      atomicAdd(steps + 0, static_cast<unsigned long long>(warp_steps));
      atomicAdd(steps + 1, static_cast<unsigned long long>(lane_steps));
    }
  }
}

template <bool kCount>
int resident_blocks() {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, traverse_kernel<kCount>, kThreads, 0);
  }
  return e == cudaSuccess ? per_sm * sms : -static_cast<int>(e);
}

}  // namespace

// Blocks of traverse_kernel (the counting build with `count`) that fit
// resident on the current device; a negative cudaError_t on failure.
extern "C" int traverse_resident_blocks(int count) {
  return count ? resident_blocks<true>() : resident_blocks<false>();
}

// `next`: a zeroed int32 on the device, fresh for each launch; `steps`:
// two zeroed uint64 for the counting build, or null.
extern "C" int traverse_launch(
    int n, int blocks, int* next, unsigned long long* steps,
    const float* clipped, const float* dirs, const float* entry_normal,
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
    auto kernel = steps != nullptr ? traverse_kernel<true>
                                   : traverse_kernel<false>;
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        P, n, next, steps, clipped, dirs, entry_normal, tminn, ok,
        index_volume, pool_words, pool_base, hit, t, normal, request,
        request_pos, exhausted, resume_t, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
