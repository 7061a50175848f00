// Probe build of kernel B2 (csrc/traverse.cu): the same walk
// (csrc/traverse_walk.inc, one thread a ray) on a grid of at most the
// resident blocks, the design measured and not shipped
// (notes/probe_torch_b2.py, `--b2 R1`, `R2`).  Its launcher takes, after
// csrc's arguments, the cursor's scratch: int32 [2], zeroed, left zeroed.
//
// BM_B2_GRID 1 and 2: at most the resident blocks (probe::resident_blocks,
// BM_B2_BLOCKS_PER_SM of them an SM), which take the next rays,
// neighbouring pixels in launch order, from a cursor in `ctl` and read the
// count again at each fetch, so a launch over a capacity whose count is
// small costs little: 32 rays a warp (1) or 128 a block (2).  With a count
// of 0 every block returns at once and the cursor is left alone, otherwise
// the last block out resets it.  0: csrc's grid, a block per 128 rows of
// the capacity, whose threads past the count return.
//
// On an H100 both resident grids built to 56 registers with an 8-byte
// stack frame (csrc's: 55, none) and ran 2-13% slower than csrc's grid at
// view 0's primaries and the shadow and cold streaming traces, while a
// count of 0 over 4,147,200 rows fell from 0.0214 to 0.0026 ms.

#include <cuda_runtime.h>

#include "traverse.cuh"
#include "probe_torch_b2_resident.cuh"

#ifndef BM_B2_GRID
#define BM_B2_GRID 1
#endif
#ifndef BM_B2_BLOCKS_PER_SM
#define BM_B2_BLOCKS_PER_SM 9
#endif

namespace {

constexpr int kThreads = 128;
constexpr unsigned int kFullWarp = 0xffffffffu;
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
#if BM_B2_GRID == 1
  if (*count <= 0) return;
  for (;;) {
    const int lane = static_cast<int>(threadIdx.x) % 32;
    int first = 0;
    if (lane == 0) first = atomicAdd(ctl + kCursor, 32);
    first = __shfl_sync(kFullWarp, first, 0);
    if (first >= *count) break;
    const int i = first + lane;
    if (i >= *count) continue;
#elif BM_B2_GRID == 2
  if (*count <= 0) return;
  __shared__ int tile;
  for (;;) {
    if (threadIdx.x == 0) tile = atomicAdd(ctl + kCursor, kThreads);
    __syncthreads();
    const int first = tile;
    __syncthreads();  // read by every thread before thread 0 writes again
    if (first >= *count) break;
    const int i = first + static_cast<int>(threadIdx.x);
    if (i >= *count) continue;
#else
  {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= *count) return;  // the grid covers the capacity >= *count
#endif

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
    resume_out[i] = bm::resume_distance(active, axis0, tx, ty, tz, ax, ay,
                                        az, bszf, tmin);
    iters_out[i] = P.max_iters - budget;
  }
#if BM_B2_GRID != 0
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
    int blocks = (n + kThreads - 1) / kThreads;
#if BM_B2_GRID != 0
    blocks = min(blocks, probe::resident_blocks(traverse_kernel, kThreads,
                                             resident, BM_B2_BLOCKS_PER_SM));
#else
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
