// Kernel B3: the segment recorder, one CUDA thread per ray.
//
// Replaces the TPU kernel brickmap_tpu/pallas/record.py::_make_kernel (:42),
// launched by record_segments (:430).  Per ray it lists the first K occupied
// brick cells front to back: the packed cell x | y << 10 | z << 20, the entry
// distance nd (cells, from the clipped origin), the entry-face axis (-1 in
// the start cell), optionally the cell's pool row, then the count and whether
// the step budget ran out.  The semantics and operation order are those of
// the plain version brickmap_tpu_torch/ops/record.py::record_segments_plain:
// the top-level DDA of kernel B2 (bm::top_step) with its Chebyshev
// empty-space skip, a cell counting as occupied when any flag bit is set,
// and no descend: an occupied cell is appended and the ray goes on.
//
// The TPU kernel carried K register sets per lane and page-voted DMA of
// superchunk tables; here a lane keeps its ray's segments in its own slot of
// dynamic shared memory (K x 8 bytes: the cell with its entry-face code, and
// nd), so one source serves any K, and it reads index_volume directly.
//
// What bounds it on an H100: dependent loads, as in B2, and its stores.
// Each step waits on one 4-byte index word whose address depends on the
// previous step; the 64 MB index volume of the full world exceeds the 50 MB
// L2.  The rays' inputs and outputs (25 + 12K + 5 bytes each, 4 more per
// segment with slots) are the rest of the traffic.  The first design stored
// each segment as it found it, one 4-byte store per array and segment, each
// landing in its own 32-byte sector: at K = 8 with slots a warp issued 32
// store instructions, 1,024 partial-sector writes, where 128 whole sectors
// carry the same bytes.  Here a lane keeps its ray's segments in shared memory and
// writes its rows whole when the ray ends, -1 fills included, with 16-byte
// stores where K % 4 == 0: that cut the kernel's time on the training
// step's frame to two fifths (notes/probe_torch_b2b3_schedule.py).  A slot
// is 8 bytes, so that 12 blocks an SM leave most of the SM's memory to the
// L1 cache (16-byte slots ran slower at that occupancy).  The probe also
// measured lanes walking runs of 2-16 rays and persistent warps refilled
// from a global counter, which keep more lanes busy: neither ran faster.
//
// Built by brickmap_tpu_torch/kernels/build.py (nvcc, sm_90a, -fmad=false);
// bound with ctypes by brickmap_tpu_torch/kernels/record.py.

#include <cuda_runtime.h>

#include "dda.cuh"


namespace {

constexpr int kThreads = 128;
constexpr int kStaticSmemMax = 48 * 1024;
constexpr unsigned int kFlagBits = 0xE0000000u;
constexpr unsigned int kLoadedBit = 0x80000000u;

struct Params {
  int cx, cy, cz;         // brick-grid extents
  int sc, sc_xy;          // superchunk edge in bricks, superchunks per xy row
  int k;                  // segments per ray
  int max_steps;          // top-level DDA steps per ray
};

struct Out {
  int* __restrict__ cells;
  float* __restrict__ nd;
  int* __restrict__ ncode;
  int* __restrict__ slot;  // null without slots
  int* __restrict__ count;
  unsigned char* __restrict__ exhausted;
};

// A segment as a lane keeps it in shared memory: the packed cell with the
// entry-face code + 1 (0..3) in bits 30-31 (cells use bits 0-29 while every
// axis has at most 1024 cells), and nd.
__device__ __forceinline__ int cell_of(int2 s) { return s.x & 0x3FFFFFFF; }

__device__ __forceinline__ int ncode_of(int2 s) {
  return static_cast<int>(static_cast<unsigned int>(s.x) >> 30) - 1;
}

__device__ __forceinline__ int nd_of(int2 s) { return s.y; }

// Record ray i into the lane's slot `seg` (segment k at seg[k * kThreads]),
// then write its rows whole.  Pool slots, which only the checks ask for, go
// straight to their row as each segment is found.
__device__ __forceinline__ void record_ray(const Params& P, int i,
                                           const float* __restrict__ o_cells,
                                           const float* __restrict__ dirs,
                                           const unsigned char* __restrict__ ok,
                                           const int* __restrict__ iv,
                                           const int* __restrict__ pool_base,
                                           int2* seg, const Out& O) {
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
      seg[count * kThreads] = make_int2(
          px | (py << 10) | (pz << 20) |
              static_cast<int>(static_cast<unsigned int>(axis0 + 1) << 30),
          __float_as_int(nd));
      if (O.slot != nullptr) {
        const int sc = px / P.sc + (py / P.sc) * P.sc_xy +
                       (pz / P.sc) * P.sc_xy * P.sc_xy;
        O.slot[row + count] =
            (word & kLoadedBit) ? pool_base[sc] + static_cast<int>(word & 0xFFFu)
                                : -1;
      }
      if (++count >= P.k) {
        alive = false;
        break;
      }
    }
    if (!bm::top_step(word, occ0, ax, ay, az, P.cx, P.cy, P.cz, px, py, pz,
                      tx, ty, tz, axis0)) {
      alive = false;  // left the grid
    }
  }

  // A field of segment k, or its fill past the count: cell -1, nd 0,
  // axis -1, slot -1.
  auto value = [&](int k, auto field, int fill) {
    return k < count ? field(seg[k * kThreads]) : fill;
  };
  if ((P.k & 3) == 0) {
    // One field of four segments at a time, to keep few registers live.
    auto quad = [&](int k, auto field, int fill) {
      return make_int4(value(k, field, fill), value(k + 1, field, fill),
                       value(k + 2, field, fill), value(k + 3, field, fill));
    };
    for (int k = 0; k < P.k; k += 4) {
      *reinterpret_cast<int4*>(O.cells + row + k) = quad(k, cell_of, -1);
      *reinterpret_cast<int4*>(O.nd + row + k) = quad(k, nd_of, 0);
      *reinterpret_cast<int4*>(O.ncode + row + k) = quad(k, ncode_of, -1);
    }
  } else {
    for (int k = 0; k < P.k; ++k) {
      O.cells[row + k] = value(k, cell_of, -1);
      O.nd[row + k] = __int_as_float(value(k, nd_of, 0));
      O.ncode[row + k] = value(k, ncode_of, -1);
    }
  }
  if (O.slot != nullptr) {
    for (int k = count; k < P.k; ++k) O.slot[row + k] = -1;
  }
  O.count[i] = count;
  O.exhausted[i] = alive;
}

__global__ void __launch_bounds__(kThreads)
record_kernel(Params P, int n, const float* __restrict__ o_cells,
              const float* __restrict__ dirs,
              const unsigned char* __restrict__ ok,
              const int* __restrict__ iv, const int* __restrict__ pool_base,
              Out O) {
  extern __shared__ int2 smem_segments[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    record_ray(P, i, o_cells, dirs, ok, iv, pool_base,
               smem_segments + threadIdx.x, O);
  }
}

// Dynamic shared memory of a launch at K segments a ray: each thread's
// K x 8-byte slot, allowed above the 48 KB default where needed.
cudaError_t smem_for(int k, size_t* smem) {
  *smem = static_cast<size_t>(kThreads) * static_cast<size_t>(k) *
          sizeof(int2);
  if (*smem <= static_cast<size_t>(kStaticSmemMax)) return cudaSuccess;
  return cudaFuncSetAttribute(record_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// With K % 4 == 0 the outputs must be 16-byte aligned; the grid has at most
// 1024 cells an axis (the caller checks both).
extern "C" int record_launch(int n, int k, const float* o_cells,
                             const float* dirs, const unsigned char* ok,
                             const int* index_volume, const int* pool_base,
                             int cells_x, int cells_y, int cells_z,
                             int sc_size, int sc_xy, int max_steps,
                             int* cells, float* nd, int* ncode, int* slot,
                             int* count, unsigned char* exhausted,
                             void* stream) {
  const Params P{cells_x, cells_y, cells_z, sc_size, sc_xy, k, max_steps};
  if (n > 0) {
    size_t smem = 0;
    const cudaError_t e = smem_for(k, &smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int blocks = (n + kThreads - 1) / kThreads;
    record_kernel<<<blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        P, n, o_cells, dirs, ok, index_volume, pool_base,
        Out{cells, nd, ncode, slot, count, exhausted});
  }
  return static_cast<int>(cudaGetLastError());
}
