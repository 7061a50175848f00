// Kernel W2 (brickmap_tpu_torch/csrc/wave.cu) under the other designs its
// redesign was measured against.  Each gives the shipped kernel's results
// bit for bit:
//   blocks    the shipped gather_clip_kernel over k blocks an SM (k = 0: a
//             block a tile, over every tile of the capacity: the hardware
//             dispatches the blocks and those past the count return);
//             probe_w2_blocks_per_sm sets k;
//   runs      the shipped kernel with a tile whose lanes are one run of
//             consecutive rows (the block's vote, __syncthreads_and)
//             loading its rays as 16-byte words into shared memory first;
//   staged    runs with every tile's rays first in shared memory (a run's
//             as 16-byte words, the others gathered), then clipped from
//             there;
//   ends      runs with a run told from the tile's two end lanes alone
//             (lanes[last] - lanes[first] = rows - 1, exact only for
//             ascending distinct lanes, as W0 gives them), no vote;
//   stride    the earlier kernel's per-row code (three 4-byte stores a row
//             for each [*, 3] output, no shared memory) in a grid-stride
//             loop over the resident blocks;
//   lb8       the shipped kernel with launch bounds of 8 blocks an SM
//             (32 registers, with spills);
//   fused     W0 with W2's work in its tile epilogue (compact_gather_
//             kernel): after a tile's set rows are staged and its offset
//             known, the block gathers and clips them and writes B2's
//             inputs at their rows; one launch for W0 + W2 over the live
//             mask, no re-read of the lanes.  Its [*, 3] outputs are
//             4-byte stores (a tile's first row is at any offset).
// runs, staged, ends, lb8 and stride launch the resident blocks (the
// occupancy calculator's count for each); all but lb8 and fused take the
// shipped kernel's launch bounds.  runs and staged call __syncthreads_and,
// which csrc/host_shim.h does not model: they run on the card only.  Built
// by notes/probe_torch_w2.py with the port's nvcc flags and -I
// brickmap_tpu_torch/csrc; the library also holds every launcher of
// wave.cu.

#include "wave.cu"

namespace {

int w2_blocks_per_sm = 8;

// `n` floats from `src` into shared `dst` (16-byte aligned), as 16-byte
// words where `src` is 16-byte aligned, else a float a thread a step.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int n) {
  const int t = static_cast<int>(threadIdx.x);
  if ((reinterpret_cast<unsigned long long>(src) & 15ull) == 0ull) {
    const int quads = n / 4;
    for (int q = t; q < quads; q += kGatherTile) {
      reinterpret_cast<float4*>(dst)[q] =
          reinterpret_cast<const float4*>(src)[q];
    }
    const int w = 4 * quads + t;
    if (w < n) dst[w] = src[w];
  } else {
    for (int w = t; w < n; w += kGatherTile) dst[w] = src[w];
  }
}

__global__ void __launch_bounds__(kGatherTile)
gather_clip_runs_kernel(const int* __restrict__ count,
                        const float* __restrict__ rays_o,
                        const float* __restrict__ rays_d,
                        const int* __restrict__ lanes, int* __restrict__ pos,
                        Box box, float* __restrict__ clipped,
                        float* __restrict__ dirs,
                        float* __restrict__ entry_normal,
                        float* __restrict__ tminn_out,
                        unsigned char* __restrict__ ok) {
  __shared__ float4 stage[5][kGatherWords / 4];
  const int n = *count;
  const int t = static_cast<int>(threadIdx.x);
  float* const s[5] = {
      reinterpret_cast<float*>(stage[0]), reinterpret_cast<float*>(stage[1]),
      reinterpret_cast<float*>(stage[2]), reinterpret_cast<float*>(stage[3]),
      reinterpret_cast<float*>(stage[4])};
  for (int base = static_cast<int>(blockIdx.x) * kGatherTile; base < n;
       base += static_cast<int>(gridDim.x) * kGatherTile) {
    const int rows = min(n - base, kGatherTile);
    const int k = base + t;
    const int lane = t < rows ? lanes[k] : 0;
    const int first = lanes[base];
    const bool run = __syncthreads_and(t >= rows || lane == first + t);
    if (run) {
      const long long at = 3 * static_cast<long long>(first);
      load_tile(s[3], rays_o + at, 3 * rows);
      load_tile(s[4], rays_d + at, 3 * rows);
      __syncthreads();
    }
    if (t < rows) {
      if (pos != nullptr) pos[lane] = k;
      float o[3], d[3];
      for (int a = 0; a < 3; ++a) {
        o[a] = run ? s[3][3 * t + a] : rays_o[3 * lane + a];
        d[a] = run ? s[4][3 * t + a] : rays_d[3 * lane + a];
      }
      const Clip c = clip_ray(box, o, d);
      for (int a = 0; a < 3; ++a) {
        s[0][3 * t + a] = c.o[a];
        s[1][3 * t + a] = d[a];
        s[2][3 * t + a] = c.en[a];
      }
      tminn_out[k] = c.tmin;
      ok[k] = c.ok;
    }
    __syncthreads();
    store_tile3(clipped, stage[0], base, rows);
    store_tile3(dirs, stage[1], base, rows);
    store_tile3(entry_normal, stage[2], base, rows);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kGatherTile, 8)
gather_clip_lb8_kernel(const int* __restrict__ count,
                       const float* __restrict__ rays_o,
                       const float* __restrict__ rays_d,
                       const int* __restrict__ lanes, int* __restrict__ pos,
                       Box box, float* __restrict__ clipped,
                       float* __restrict__ dirs,
                       float* __restrict__ entry_normal,
                       float* __restrict__ tminn_out,
                       unsigned char* __restrict__ ok) {
  __shared__ float4 stage[3][kGatherWords / 4];
  const int n = *count;
  const int t = static_cast<int>(threadIdx.x);
  for (int base = static_cast<int>(blockIdx.x) * kGatherTile; base < n;
       base += static_cast<int>(gridDim.x) * kGatherTile) {
    const int rows = min(n - base, kGatherTile);
    if (t < rows) {
      const int k = base + t;
      const int lane = lanes[k];
      if (pos != nullptr) pos[lane] = k;
      const float o[3] = {rays_o[3 * lane], rays_o[3 * lane + 1],
                          rays_o[3 * lane + 2]};
      const float d[3] = {rays_d[3 * lane], rays_d[3 * lane + 1],
                          rays_d[3 * lane + 2]};
      const Clip c = clip_ray(box, o, d);
      float* const s[3] = {reinterpret_cast<float*>(stage[0]),
                           reinterpret_cast<float*>(stage[1]),
                           reinterpret_cast<float*>(stage[2])};
      for (int a = 0; a < 3; ++a) {
        s[0][3 * t + a] = c.o[a];
        s[1][3 * t + a] = d[a];
        s[2][3 * t + a] = c.en[a];
      }
      tminn_out[k] = c.tmin;
      ok[k] = c.ok;
    }
    __syncthreads();
    store_tile3(clipped, stage[0], base, rows);
    store_tile3(dirs, stage[1], base, rows);
    store_tile3(entry_normal, stage[2], base, rows);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kGatherTile)
gather_clip_stride_kernel(const int* __restrict__ count,
                          const float* __restrict__ rays_o,
                          const float* __restrict__ rays_d,
                          const int* __restrict__ lanes,
                          int* __restrict__ pos, Box box,
                          float* __restrict__ clipped,
                          float* __restrict__ dirs,
                          float* __restrict__ entry_normal,
                          float* __restrict__ tminn_out,
                          unsigned char* __restrict__ ok) {
  const int n = *count;
  for (int k = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
       k < n; k += static_cast<int>(gridDim.x * blockDim.x)) {
    const int lane = lanes[k];
    if (pos != nullptr) pos[lane] = k;
    const float o[3] = {rays_o[3 * lane], rays_o[3 * lane + 1],
                        rays_o[3 * lane + 2]};
    const float d[3] = {rays_d[3 * lane], rays_d[3 * lane + 1],
                        rays_d[3 * lane + 2]};
    const Clip c = clip_ray(box, o, d);
    for (int a = 0; a < 3; ++a) {
      clipped[3 * k + a] = c.o[a];
      dirs[3 * k + a] = d[a];
      entry_normal[3 * k + a] = c.en[a];
    }
    tminn_out[k] = c.tmin;
    ok[k] = c.ok;
  }
}

__global__ void __launch_bounds__(kGatherTile)
gather_clip_staged_kernel(const int* __restrict__ count,
                          const float* __restrict__ rays_o,
                          const float* __restrict__ rays_d,
                          const int* __restrict__ lanes,
                          int* __restrict__ pos, Box box,
                          float* __restrict__ clipped,
                          float* __restrict__ dirs,
                          float* __restrict__ entry_normal,
                          float* __restrict__ tminn_out,
                          unsigned char* __restrict__ ok) {
  __shared__ float4 stage[5][kGatherWords / 4];
  const int n = *count;
  const int t = static_cast<int>(threadIdx.x);
  float* const s[5] = {
      reinterpret_cast<float*>(stage[0]), reinterpret_cast<float*>(stage[1]),
      reinterpret_cast<float*>(stage[2]), reinterpret_cast<float*>(stage[3]),
      reinterpret_cast<float*>(stage[4])};
  for (int base = static_cast<int>(blockIdx.x) * kGatherTile; base < n;
       base += static_cast<int>(gridDim.x) * kGatherTile) {
    const int rows = min(n - base, kGatherTile);
    const int first = lanes[base];
    const bool run =
        __syncthreads_and(t >= rows || lanes[base + t] == first + t);
    if (run) {
      const long long at = 3 * static_cast<long long>(first);
      load_tile(s[3], rays_o + at, 3 * rows);
      load_tile(s[4], rays_d + at, 3 * rows);
    } else if (t < rows) {
      const long long at = 3 * static_cast<long long>(lanes[base + t]);
      for (int a = 0; a < 3; ++a) {
        s[3][3 * t + a] = rays_o[at + a];
        s[4][3 * t + a] = rays_d[at + a];
      }
    }
    __syncthreads();
    if (t < rows) {
      const int k = base + t;
      if (pos != nullptr) pos[run ? first + t : lanes[k]] = k;
      float o[3], d[3];
      for (int a = 0; a < 3; ++a) {
        o[a] = s[3][3 * t + a];
        d[a] = s[4][3 * t + a];
      }
      const Clip c = clip_ray(box, o, d);
      for (int a = 0; a < 3; ++a) {
        s[0][3 * t + a] = c.o[a];
        s[1][3 * t + a] = d[a];
        s[2][3 * t + a] = c.en[a];
      }
      tminn_out[k] = c.tmin;
      ok[k] = c.ok;
    }
    __syncthreads();
    store_tile3(clipped, stage[0], base, rows);
    store_tile3(dirs, stage[1], base, rows);
    store_tile3(entry_normal, stage[2], base, rows);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kGatherTile)
gather_clip_ends_kernel(const int* __restrict__ count,
                        const float* __restrict__ rays_o,
                        const float* __restrict__ rays_d,
                        const int* __restrict__ lanes, int* __restrict__ pos,
                        Box box, float* __restrict__ clipped,
                        float* __restrict__ dirs,
                        float* __restrict__ entry_normal,
                        float* __restrict__ tminn_out,
                        unsigned char* __restrict__ ok) {
  __shared__ float4 stage[5][kGatherWords / 4];
  const int n = *count;
  const int t = static_cast<int>(threadIdx.x);
  float* const s[5] = {
      reinterpret_cast<float*>(stage[0]), reinterpret_cast<float*>(stage[1]),
      reinterpret_cast<float*>(stage[2]), reinterpret_cast<float*>(stage[3]),
      reinterpret_cast<float*>(stage[4])};
  for (int base = static_cast<int>(blockIdx.x) * kGatherTile; base < n;
       base += static_cast<int>(gridDim.x) * kGatherTile) {
    const int rows = min(n - base, kGatherTile);
    const int first = lanes[base];
    const bool run = lanes[base + rows - 1] - first == rows - 1;
    if (run) {
      const long long at = 3 * static_cast<long long>(first);
      load_tile(s[3], rays_o + at, 3 * rows);
      load_tile(s[4], rays_d + at, 3 * rows);
    }
    __syncthreads();
    if (t < rows) {
      const int k = base + t;
      const int lane = run ? first + t : lanes[k];
      if (pos != nullptr) pos[lane] = k;
      float o[3], d[3];
      for (int a = 0; a < 3; ++a) {
        o[a] = run ? s[3][3 * t + a] : rays_o[3 * lane + a];
        d[a] = run ? s[4][3 * t + a] : rays_d[3 * lane + a];
      }
      const Clip c = clip_ray(box, o, d);
      for (int a = 0; a < 3; ++a) {
        s[0][3 * t + a] = c.o[a];
        s[1][3 * t + a] = d[a];
        s[2][3 * t + a] = c.en[a];
      }
      tminn_out[k] = c.tmin;
      ok[k] = c.ok;
    }
    __syncthreads();
    store_tile3(clipped, stage[0], base, rows);
    store_tile3(dirs, stage[1], base, rows);
    store_tile3(entry_normal, stage[2], base, rows);
    __syncthreads();
  }
}

// W2's outputs and inputs for the fused kernel.
struct Gather {
  const float *rays_o, *rays_d;
  int* pos;
  Box box;
  float *clipped, *dirs, *entry_normal, *tminn;
  unsigned char* ok;
};

__device__ __forceinline__ void gather_row(const Gather& g, int k, int lane) {
  if (g.pos != nullptr) g.pos[lane] = k;
  const float o[3] = {g.rays_o[3 * lane], g.rays_o[3 * lane + 1],
                      g.rays_o[3 * lane + 2]};
  const float d[3] = {g.rays_d[3 * lane], g.rays_d[3 * lane + 1],
                      g.rays_d[3 * lane + 2]};
  const Clip c = clip_ray(g.box, o, d);
  for (int a = 0; a < 3; ++a) {
    g.clipped[3 * k + a] = c.o[a];
    g.dirs[3 * k + a] = d[a];
    g.entry_normal[3 * k + a] = c.en[a];
  }
  g.tminn[k] = c.tmin;
  g.ok[k] = c.ok;
}

// compact_kernel (no limit) with W2 in its tile epilogue.
__global__ void __launch_bounds__(kScanThreads)
compact_gather_kernel(int cap, const unsigned char* __restrict__ mask,
                      int* __restrict__ out, int* __restrict__ count,
                      unsigned long long* __restrict__ scratch, Gather g) {
  __shared__ int stage[kScanTile];
  __shared__ int warp_sums[kScanWarps];
  __shared__ int next_tile, offset, last_out;
  int* const ctl = reinterpret_cast<int*>(scratch);
  unsigned long long* const status = scratch + kCtlWords;
  const int rows = cap;
  const int tiles = (rows + kScanTile - 1) / kScanTile;
  if (tiles == 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *count = 0;
    return;
  }
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  if (threadIdx.x == 0) next_tile = atomicAdd(ctl + kW0Cursor, 1);
  __syncthreads();
  for (int tile = next_tile; tile < tiles; tile = next_tile) {
    const int base = tile * kScanTile;
    const unsigned int bits = tile_bits(mask, rows, base);
    const int own = __popc(bits);
    int rank = own;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFullWarp, rank, d);
      if (lane >= d) rank += up;
    }
    if (lane == 31) warp_sums[warp] = rank;
    __syncthreads();
    rank -= own;
    int total = 0;
    for (int w = 0; w < kScanWarps; ++w) {
      const int v = warp_sums[w];
      rank += w < warp ? v : 0;
      total += v;
    }
    if (warp == 0) {
      int before = 0;
      if (tile == 0) {
        if (lane == 0) store_status(status, kInclusive, total);
      } else {
        if (lane == 0) store_status(status + tile, kAggregate, total);
        before = look_back(status, tile);
        if (lane == 0) store_status(status + tile, kInclusive, before + total);
      }
      if (lane == 0) offset = before;
    }
    const int r0 = base + static_cast<int>(threadIdx.x) * kScanItems;
    for (int k = 0; k < kScanItems; ++k) {
      if ((bits >> k) & 1u) stage[rank++] = r0 + k;
    }
    __syncthreads();
    const int before = offset;
    if (threadIdx.x == 0) next_tile = atomicAdd(ctl + kW0Cursor, 1);
    for (int j = static_cast<int>(threadIdx.x); j < total; j += kScanThreads) {
      out[before + j] = stage[j];
      gather_row(g, before + j, stage[j]);
    }
    if (tile == tiles - 1 && threadIdx.x == 0) *count = before + total;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    __threadfence();
    last_out = atomicAdd(ctl + kW0Exits, 1) ==
               static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (last_out) {
    for (int t = static_cast<int>(threadIdx.x); t < tiles;
         t += kScanThreads) {
      status[t] = 0ull;
    }
    if (threadIdx.x == 0) ctl[kW0Cursor] = ctl[kW0Exits] = 0;
  }
}

int sm_count() {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

extern "C" void probe_w2_blocks_per_sm(int k) { w2_blocks_per_sm = k; }

#define W2_PARAMS                                                            \
  int cap, const int *count, const float *rays_o, const float *rays_d,      \
      const int *lanes, int *pos, float hi_x, float hi_y, float hi_z,        \
      float center_x, float center_y, float center_z, float scale_xy,        \
      float eps, float *clipped, float *dirs, float *entry_normal,           \
      float *tminn, unsigned char *ok, void *stream

extern "C" int wave_gather_clip_blocks_launch(W2_PARAMS) {
  const Box box{{hi_x, hi_y, hi_z}, {center_x, center_y, center_z}, scale_xy,
                eps};
  if (cap > 0) {
    const int tiles = (cap + kGatherTile - 1) / kGatherTile;
    const int grid = w2_blocks_per_sm > 0
                         ? min(tiles, sm_count() * w2_blocks_per_sm)
                         : tiles;
    gather_clip_kernel<<<grid, kGatherTile, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        count, rays_o, rays_d, lanes, pos, box, clipped, dirs, entry_normal,
        tminn, ok);
  }
  return static_cast<int>(cudaGetLastError());
}

#define W2_RESIDENT_LAUNCH(name, kernel)                                     \
  extern "C" int name(W2_PARAMS) {                                           \
    static int resident[64] = {};                                            \
    const Box box{{hi_x, hi_y, hi_z}, {center_x, center_y, center_z},        \
                  scale_xy, eps};                                            \
    if (cap > 0) {                                                           \
      const int tiles = (cap + kGatherTile - 1) / kGatherTile;               \
      kernel<<<min(tiles, resident_blocks(kernel, kGatherTile, resident)),   \
               kGatherTile, 0, static_cast<cudaStream_t>(stream)>>>(         \
          count, rays_o, rays_d, lanes, pos, box, clipped, dirs,             \
          entry_normal, tminn, ok);                                          \
    }                                                                        \
    return static_cast<int>(cudaGetLastError());                             \
  }

W2_RESIDENT_LAUNCH(wave_gather_clip_runs_launch, gather_clip_runs_kernel)
W2_RESIDENT_LAUNCH(wave_gather_clip_stride_launch, gather_clip_stride_kernel)
W2_RESIDENT_LAUNCH(wave_gather_clip_staged_launch, gather_clip_staged_kernel)
W2_RESIDENT_LAUNCH(wave_gather_clip_ends_launch, gather_clip_ends_kernel)
W2_RESIDENT_LAUNCH(wave_gather_clip_lb8_launch, gather_clip_lb8_kernel)

// W0 over the whole mask (no limit) with W2 fused: W0's arguments, then
// W2's after its count and lanes.
extern "C" int wave_compact_gather_launch(
    int cap, const unsigned char* mask, int* out, int* count,
    unsigned long long* scratch, const float* rays_o, const float* rays_d,
    int* pos, float hi_x, float hi_y, float hi_z, float center_x,
    float center_y, float center_z, float scale_xy, float eps,
    float* clipped, float* dirs, float* entry_normal, float* tminn,
    unsigned char* ok, void* stream) {
  static int resident[64] = {};
  const Gather g{rays_o,  rays_d, pos,
                 Box{{hi_x, hi_y, hi_z}, {center_x, center_y, center_z},
                     scale_xy, eps},
                 clipped, dirs,   entry_normal, tminn, ok};
  if (cap > 0) {
    const int tiles = (cap + kScanTile - 1) / kScanTile;
    compact_gather_kernel<<<min(tiles,
                                resident_blocks(compact_gather_kernel,
                                                kScanThreads, resident)),
                            kScanThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        cap, mask, out, count, scratch, g);
  }
  return static_cast<int>(cudaGetLastError());
}
