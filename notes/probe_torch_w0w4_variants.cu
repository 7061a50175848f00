// Kernel W4 (brickmap_tpu_torch/csrc/wave.cu) under the other schedules
// its redesign was measured against.  Each ray's passes are the shipped
// rescue_ray, so all give the same results bit for bit:
//   stride  a plain grid-stride loop over the resident blocks: thread k of
//           the grid rescues rows k, k + G, k + 2G, ... (G the grid's
//           threads);
//   block   each resident block takes the next 128 rows from the cursor, a
//           thread a row (the earlier grid's order of rows on the SMs,
//           without its grid over the capacity);
//   ahead   the shipped warps' 32 rows at a time, each warp's next 32 taken
//           before it starts the current ones;
//   held    the shipped warps' fetch with the count read once and held in
//           a register across the rays (the first form of the redesign);
//   cap128  the earlier schedule (a thread a row of the capacity, each
//           past the count returning at once) over rescue_ray;
//   blocks  the shipped kernel, or held's, over k blocks an SM
//           (probe_blocks_per_sm sets k and which).
// stride, block, ahead and held launch the occupancy calculator's resident
// blocks.  Built by notes/probe_torch_w0w4.py with the port's nvcc flags
// and -I brickmap_tpu_torch/csrc; the library also holds every launcher of
// wave.cu, and adds wave_rescue_<schedule>_launch with
// wave_rescue_launch's signature.

#include "wave.cu"

namespace {

// The last block out of a launch resets W4's cursor (as rescue_kernel).
__device__ __forceinline__ void count_out(int* ctl) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(ctl + kW4Exits, 1) == static_cast<int>(gridDim.x) - 1) {
      ctl[kW4Cursor] = ctl[kW4Exits] = 0;
    }
  }
}

#define RESCUE_KERNEL(name)                                                  \
  __global__ void __launch_bounds__(kRescueThreads) name(                    \
      const int* __restrict__ count, const int* __restrict__ rows,           \
      const int* __restrict__ lanes, const float* __restrict__ rays_o,       \
      const float* __restrict__ rays_d, Box box, bm::TraverseParams P,       \
      int passes, const int* __restrict__ iv, const int* __restrict__ pool,  \
      const int* __restrict__ pool_base, Rescued res, int* __restrict__ ctl)

#define RESCUE_RAY(j)                                                        \
  rescue_ray(rows[j], lanes, rays_o, rays_d, box, P, passes, iv, pool,       \
             pool_base, res)

RESCUE_KERNEL(rescue_stride_kernel) {
  const int n = *count;
  if (passes <= 0) return;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    RESCUE_RAY(j);
  }
  (void)ctl;
}

RESCUE_KERNEL(rescue_block_kernel) {
  __shared__ int first;
  const int n = *count;
  if (passes <= 0 || n <= 0) return;
  for (;;) {
    if (threadIdx.x == 0) first = atomicAdd(ctl + kW4Cursor, kRescueThreads);
    __syncthreads();
    const int j = first + static_cast<int>(threadIdx.x);
    const bool done = first >= n;
    __syncthreads();
    if (done) break;
    if (j < n) RESCUE_RAY(j);
  }
  count_out(ctl);
}

RESCUE_KERNEL(rescue_ahead_kernel) {
  const int n = *count;
  if (passes <= 0 || n <= 0) return;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  int next = 0;
  if (lane == 0) next = atomicAdd(ctl + kW4Cursor, 32);
  for (;;) {
    const int first = __shfl_sync(kFullWarp, next, 0);
    if (first >= n) break;
    if (lane == 0) next = atomicAdd(ctl + kW4Cursor, 32);
    if (first + lane < n) RESCUE_RAY(first + lane);
  }
  count_out(ctl);
}

RESCUE_KERNEL(rescue_held_kernel) {
  const int n = *count;
  if (passes <= 0 || n <= 0) return;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  for (;;) {
    int first = 0;
    if (lane == 0) first = atomicAdd(ctl + kW4Cursor, 32);
    first = __shfl_sync(kFullWarp, first, 0);
    if (first >= n) break;
    if (first + lane < n) RESCUE_RAY(first + lane);
  }
  count_out(ctl);
}

RESCUE_KERNEL(rescue_cap_kernel) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (passes <= 0 || j >= *count) return;
  RESCUE_RAY(j);
  (void)ctl;
}

}  // namespace

#define RESCUE_PARAMS                                                        \
  int cap, const int *count, const int *rows, const int *lanes,              \
      const float *rays_o, const float *rays_d, float hi_x, float hi_y,      \
      float hi_z, float center_x, float center_y, float center_z,            \
      float scale_xy, float eps, const int *index_volume,                    \
      const int *pool_words, const int *pool_base, int cells_x,              \
      int cells_y, int cells_z, int sc_size, int sc_xy, int num_sc,          \
      int cam_x, int cam_y, int cam_z, int lod8, int lod2, int brick_size,   \
      float epsilon, int budget, int passes, unsigned char *hit, float *t,   \
      float *normal, unsigned char *request, int *request_pos,              \
      unsigned char *exhausted, float *resume_t,                             \
      unsigned long long *scratch, void *stream

// Launches `kernel` over `blocks` blocks (at most a thread a row).
#define RESCUE_LAUNCH(kernel, blocks)                                        \
  const Box box{{hi_x, hi_y, hi_z}, {center_x, center_y, center_z},          \
                scale_xy, eps};                                              \
  const bm::TraverseParams P{cells_x, cells_y,  cells_z, sc_size,            \
                             sc_xy,   num_sc,   cam_x,   cam_y,              \
                             cam_z,   lod8,     lod2,    brick_size,         \
                             epsilon, budget};                               \
  const Rescued res{hit, request, exhausted, t, normal, resume_t,            \
                    request_pos};                                            \
  if (cap > 0) {                                                             \
    kernel<<<min((cap + kRescueThreads - 1) / kRescueThreads, blocks),       \
             kRescueThreads, 0, static_cast<cudaStream_t>(stream)>>>(        \
        count, rows, lanes, rays_o, rays_d, box, P, passes, index_volume,    \
        pool_words, pool_base, res, reinterpret_cast<int*>(scratch));        \
  }                                                                          \
  return static_cast<int>(cudaGetLastError());

#define RESIDENT_LAUNCH(name, kernel)                                        \
  extern "C" int name(RESCUE_PARAMS) {                                       \
    static int resident[64] = {};                                            \
    RESCUE_LAUNCH(kernel, resident_blocks(kernel, kRescueThreads, resident)) \
  }

RESIDENT_LAUNCH(wave_rescue_stride_launch, rescue_stride_kernel)
RESIDENT_LAUNCH(wave_rescue_block_launch, rescue_block_kernel)
RESIDENT_LAUNCH(wave_rescue_ahead_launch, rescue_ahead_kernel)
RESIDENT_LAUNCH(wave_rescue_held_launch, rescue_held_kernel)

extern "C" int wave_rescue_cap128_launch(RESCUE_PARAMS) {
  RESCUE_LAUNCH(rescue_cap_kernel, 1 << 30)
}

static int blocks_per_sm = 8;
static bool blocks_held = false;

extern "C" void probe_blocks_per_sm(int k, int held) {
  blocks_per_sm = k;
  blocks_held = held != 0;
}

extern "C" int wave_rescue_blocks_launch(RESCUE_PARAMS) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (blocks_held) {
    RESCUE_LAUNCH(rescue_held_kernel, sms * blocks_per_sm)
  }
  RESCUE_LAUNCH(rescue_kernel, sms * blocks_per_sm)
}
