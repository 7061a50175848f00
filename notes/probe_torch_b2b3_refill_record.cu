// Probe kernel: B3 on persistent warps that refill finished lanes from a
// global counter, measured by notes/probe_torch_b2b3_schedule.py against
// the first design (one thread per ray) and the shipped kernel
// (brickmap_tpu_torch/csrc/record.cu).  It computes what the shipped kernel
// computes, bit for bit; only the schedule and the segment slots differ.
//
// The grid holds only the blocks that fit resident; each warp takes rays
// from the global counter `next` in batches of kBatch and, whenever kRefill
// of its lanes have finished, starts the next rays of its batch in those
// lanes (bm::refill).  A lane keeps its ray's segments in a 16-byte slot of
// dynamic shared memory each (cell, nd, axis, pool row) and writes its rows
// whole when the ray ends.  With kCount the build also sums the warps'
// iterations that took a step (steps[0]) and the lanes' steps (steps[1]).
//
// Built with the port's nvcc flags, -I brickmap_tpu_torch/csrc and the
// macros BM_RECORD_REFILL, BM_RECORD_MIN_BLOCKS and PROBE_BATCH.

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
#ifndef BM_RECORD_REFILL
#define BM_RECORD_REFILL 8
#endif
#ifndef BM_RECORD_MIN_BLOCKS
#define BM_RECORD_MIN_BLOCKS 12
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kRefill = BM_RECORD_REFILL;
#ifndef PROBE_BATCH
#define PROBE_BATCH 32
#endif
constexpr int kBatch = PROBE_BATCH;  // rays a warp takes from the counter at once
constexpr int kMinBlocks = BM_RECORD_MIN_BLOCKS;
constexpr int kStaticSmemMax = 48 * 1024;
constexpr unsigned int kFlagBits = 0xE0000000u;
constexpr unsigned int kLoadedBit = 0x80000000u;

struct Params {
  int cx, cy, cz;         // brick-grid extents
  int sc, sc_xy;          // superchunk edge in bricks, superchunks per xy row
  int k;                  // segments per ray
  int max_steps;          // top-level DDA steps per ray
};

// The unused tail of a row: cell -1, nd 0, axis -1, slot -1.
__device__ __forceinline__ int4 segment_or_fill(const int4* slot, int k,
                                                int count) {
  return k < count ? slot[k * kThreads] : make_int4(-1, 0, -1, -1);
}

// kCount: also sum, over the warps' iterations, the steps issued (1 while
// any lane steps) in steps[0] and the lanes' steps in steps[1].
template <bool kCount>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
record_kernel(Params P, int n, int* __restrict__ next,
              unsigned long long* __restrict__ steps,
              const float* __restrict__ o_cells,
              const float* __restrict__ dirs,
              const unsigned char* __restrict__ ok,
              const int* __restrict__ iv, const int* __restrict__ pool_base,
              int* __restrict__ cells_out, float* __restrict__ nd_out,
              int* __restrict__ ncode_out, int* __restrict__ slot_out,
              int* __restrict__ count_out,
              unsigned char* __restrict__ exhausted_out) {
  // This lane's segments, segment k at seg[k * kThreads]: the lanes of a
  // warp touch consecutive 16-byte words.
  extern __shared__ int4 smem_segments[];
  int4* const seg = smem_segments + threadIdx.x;
  int ray = -1;             // this lane's ray; < 0: idle
  int bnext = 0, bend = 0;  // the warp's rays not yet started
  bm::Axis ax, ay, az;
  int px = 0, py = 0, pz = 0;
  float tx = 0.0f, ty = 0.0f, tz = 0.0f;
  int count = 0, budget = 0;
  int axis0 = -1;  // axis of the face through which the current cell was
                   // entered (-1: the start cell)
  bool alive = false;
  unsigned int warp_steps = 0, lane_steps = 0;

  for (;;) {
    if (bm::refill(ray, bnext, bend, next, n, kRefill, kBatch)) {
      ax = bm::make_axis(dirs[3 * ray + 0]);
      ay = bm::make_axis(dirs[3 * ray + 1]);
      az = bm::make_axis(dirs[3 * ray + 2]);
      bm::axis_start(o_cells[3 * ray + 0], ax, px, tx);
      bm::axis_start(o_cells[3 * ray + 1], ay, py, ty);
      bm::axis_start(o_cells[3 * ray + 2], az, pz, tz);
      alive = ok[ray] && px >= 0 && px < P.cx && py >= 0 && py < P.cy &&
              pz >= 0 && pz < P.cz;
      count = 0;
      budget = P.max_steps;
      axis0 = -1;
    }
    if (__ballot_sync(bm::kFullWarp, ray >= 0) == 0u) break;

    int spent = 0;
    if (ray >= 0) {
      if (alive && budget > 0) {
        --budget;
        spent = 1;
        const unsigned int word = static_cast<unsigned int>(
            iv[(pz * P.cy + py) * P.cx + px]);
        const bool occ0 = (word & kFlagBits) != 0u;
        if (occ0) {
          float nd = 0.0f;
          if (axis0 >= 0) {
            nd = bm::sel3(axis0, tx, ty, tz) -
                 bm::sel3(axis0, ax.td, ay.td, az.td);
          }
          int slot = -1;
          if (slot_out != nullptr && (word & kLoadedBit)) {
            const int sc = px / P.sc + (py / P.sc) * P.sc_xy +
                           (pz / P.sc) * P.sc_xy * P.sc_xy;
            slot = pool_base[sc] + static_cast<int>(word & 0xFFFu);
          }
          seg[count * kThreads] = make_int4(px | (py << 10) | (pz << 20),
                                            __float_as_int(nd), axis0, slot);
          if (++count >= P.k) alive = false;
        }
        if (alive && !bm::top_step(word, occ0, ax, ay, az, P.cx, P.cy, P.cz,
                                   px, py, pz, tx, ty, tz, axis0)) {
          alive = false;  // left the grid
        }
      }

      if (!alive || budget == 0) {  // the ray ended: write its rows whole
        const long long row = static_cast<long long>(ray) * P.k;
        if ((P.k & 3) == 0) {
          // One field of four segments at a time, to keep few registers.
          auto quad = [&](int k, auto field) {
            return make_int4(field(segment_or_fill(seg, k + 0, count)),
                             field(segment_or_fill(seg, k + 1, count)),
                             field(segment_or_fill(seg, k + 2, count)),
                             field(segment_or_fill(seg, k + 3, count)));
          };
          for (int k = 0; k < P.k; k += 4) {
            *reinterpret_cast<int4*>(cells_out + row + k) =
                quad(k, [](int4 s) { return s.x; });
            *reinterpret_cast<int4*>(nd_out + row + k) =
                quad(k, [](int4 s) { return s.y; });
            *reinterpret_cast<int4*>(ncode_out + row + k) =
                quad(k, [](int4 s) { return s.z; });
            if (slot_out != nullptr) {
              *reinterpret_cast<int4*>(slot_out + row + k) =
                  quad(k, [](int4 s) { return s.w; });
            }
          }
        } else {
          for (int k = 0; k < P.k; ++k) {
            const int4 s = segment_or_fill(seg, k, count);
            cells_out[row + k] = s.x;
            nd_out[row + k] = __int_as_float(s.y);
            ncode_out[row + k] = s.z;
            if (slot_out != nullptr) slot_out[row + k] = s.w;
          }
        }
        count_out[ray] = count;
        exhausted_out[ray] = alive;
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

// Dynamic shared memory of a launch with K segments a ray.
size_t smem_bytes(int k) {
  return static_cast<size_t>(kThreads) * static_cast<size_t>(k) *
         sizeof(int4);
}

template <bool kCount>
cudaError_t allow_smem(size_t smem) {
  if (smem <= static_cast<size_t>(kStaticSmemMax)) return cudaSuccess;
  return cudaFuncSetAttribute(record_kernel<kCount>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kCount>
int resident_blocks(int k) {
  const size_t smem = smem_bytes(k);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = allow_smem<kCount>(smem);
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, record_kernel<kCount>, kThreads, smem);
  }
  return e == cudaSuccess ? per_sm * sms : -static_cast<int>(e);
}

}  // namespace

// Blocks of record_kernel at K segments a ray (the counting build with
// `count`) that fit resident on the current device; a negative cudaError_t
// on failure.
extern "C" int record_resident_blocks(int k, int count) {
  return count ? resident_blocks<true>(k) : resident_blocks<false>(k);
}

// `next`: a zeroed int32 on the device, fresh for each launch; `steps`: two
// zeroed uint64 for the counting build, or null.  With K % 4 == 0 the
// outputs must be 16-byte aligned.
extern "C" int record_launch(int n, int blocks, int* next,
                             unsigned long long* steps, int k,
                             const float* o_cells, const float* dirs,
                             const unsigned char* ok,
                             const int* index_volume, const int* pool_base,
                             int cells_x, int cells_y, int cells_z,
                             int sc_size, int sc_xy, int max_steps,
                             int* cells, float* nd, int* ncode, int* slot,
                             int* count, unsigned char* exhausted,
                             void* stream) {
  const Params P{cells_x, cells_y, cells_z, sc_size, sc_xy, k, max_steps};
  if (n > 0) {
    const size_t smem = smem_bytes(k);
    const bool counting = steps != nullptr;
    const cudaError_t e =
        counting ? allow_smem<true>(smem) : allow_smem<false>(smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    auto kernel = counting ? record_kernel<true> : record_kernel<false>;
    kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        P, n, next, steps, o_cells, dirs, ok, index_volume, pool_base, cells,
        nd, ncode, slot, count, exhausted);
  }
  return static_cast<int>(cudaGetLastError());
}
