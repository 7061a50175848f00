// Kernel B3: the segment recorder, one CUDA thread per ray.
//
// Replaces the TPU kernel brickmap_tpu/pallas/record.py::_make_kernel (:42),
// launched by record_segments (:430).  Per ray it lists the first K occupied
// brick cells front to back: the packed cell x | y << 10 | z << 20, the entry
// distance nd (cells, from the clipped origin), the entry-face axis (-1 in
// the start cell), optionally the cell's pool row, then the count and whether
// the step budget ran out.  The semantics and operation order are those of
// the plain version brickmap_tpu_torch/ops/record.py::record_segments_plain:
// the top-level DDA of csrc/traverse.cu with its Chebyshev empty-space skip
// (index-word bits 28:20), a cell counting as occupied when any flag bit is
// set, and no descend: an occupied cell is appended and the ray goes on.
//
// The TPU kernel carried K register sets per lane and page-voted DMA of
// superchunk tables; here a thread writes each segment straight to
// out[ray * K + count] when it finds it, so one source serves any K, and it
// reads index_volume directly.
//
// What bounds it on an H100: dependent loads, as in B2.  Each step waits on
// one 4-byte index word whose address depends on the previous step; the
// 64 MB index volume of the full world exceeds the 50 MB L2.  The rays'
// inputs and outputs (25 + 12K + 5 bytes each, 16 more per segment with
// slots) are the rest of the traffic.  Rays of a warp diverge in step count.
//
// Built by brickmap_tpu_torch/kernels/build.py (nvcc, sm_90a, -fmad=false);
// bound with ctypes by brickmap_tpu_torch/kernels/record.py.

#include <cuda_runtime.h>

#include "dda.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned int kFlagBits = 0xE0000000u;
constexpr unsigned int kLoadedBit = 0x80000000u;

struct Params {
  int cx, cy, cz;         // brick-grid extents
  int sc, sc_xy;          // superchunk edge in bricks, superchunks per xy row
  int k;                  // segments per ray
  int max_steps;          // top-level DDA steps per ray
};

__global__ void __launch_bounds__(kThreads)
record_kernel(Params P, int n, const float* __restrict__ o_cells,
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
    const int blocks = (n + kThreads - 1) / kThreads;
    record_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        P, n, o_cells, dirs, ok, index_volume, pool_base, cells, nd, ncode,
        slot, count, exhausted);
  }
  return static_cast<int>(cudaGetLastError());
}
