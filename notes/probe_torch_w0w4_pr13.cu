// Kernels W0 and W4 as brickmap_tpu_torch/csrc/wave.cu had them before
// their redesign, kept verbatim (with the helpers they use) as the baseline
// that notes/probe_torch_w0w4.py times the redesign against:
//   W0 compact_count_kernel + compact_write_kernel: each 4096-row tile's
//      count, then each tile's offset (the block sums the counts of the
//      tiles before it), the rows' ranks from block scans, and the writes;
//      two launches of ceil(cap / 4096) blocks.
//   W4 rescue_kernel: a thread a row of the capacity, each past the count
//      returning at once.
// The launchers keep their earlier C signatures (wave_compact_launch with
// a per-call int32 `parts` buffer of a count a tile; wave_rescue_launch
// without the scratch).  Built by the probe with the port's nvcc flags and
// -I brickmap_tpu_torch/csrc.

#include <cuda_runtime.h>

#include <math.h>

#include "traverse.cuh"

namespace {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float clamp_min0(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// torch.maximum / amax and torch.minimum / amin: NaN propagates.
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float sign_of(float v) {
  return static_cast<float>((0.0f < v) - (v < 0.0f));
}

__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// ---- W0 -----------------------------------------------------------------

// A tile of kScanTile rows a block, kScanItems consecutive rows a thread.
constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;
constexpr int kScanTile = kScanThreads * kScanItems;

// The rows of the mask the compaction reads: all `cap`, or the first
// *limit of them (the exhausted rays among a trace's compacted ones).
__device__ __forceinline__ int mask_rows(int cap, const int* limit) {
  return limit != nullptr ? min(cap, *limit) : cap;
}

// Thread t's flags of the tile at `base` as bits (bit j: row base + 16 t +
// j), rows at or past `rows` clear.  A thread whose 16 rows are all inside
// reads them as one 16-byte word (the mask is 16-byte aligned).
__device__ __forceinline__ unsigned int tile_bits(
    const unsigned char* __restrict__ mask, int rows, int base) {
  const int r0 = base + static_cast<int>(threadIdx.x) * kScanItems;
  unsigned int bits = 0u;
  if (r0 + kScanItems <= rows) {
    const uint4 v = *reinterpret_cast<const uint4*>(mask + r0);
    const unsigned int w[4] = {v.x, v.y, v.z, v.w};
    for (int k = 0; k < kScanItems; ++k) {
      bits |= (((w[k / 4] >> (8 * (k % 4))) & 0xFFu) != 0u ? 1u : 0u) << k;
    }
  } else {
    for (int k = 0; k < kScanItems && r0 + k < rows; ++k) {
      bits |= (mask[r0 + k] != 0 ? 1u : 0u) << k;
    }
  }
  return bits;
}

__device__ __forceinline__ int popcount16(unsigned int bits) {
  int c = 0;
  for (int k = 0; k < kScanItems; ++k) c += (bits >> k) & 1u;
  return c;
}

// Exclusive prefix sum of v over the block's threads (Hillis-Steele in
// shared memory), and the block's total.  Every thread must call it.
__device__ __forceinline__ int block_scan(int v, int& total) {
  __shared__ int buf[2][kScanThreads];
  int cur = 0;
  buf[0][threadIdx.x] = v;
  __syncthreads();
  for (int s = 1; s < kScanThreads; s <<= 1) {
    const int x = buf[cur][threadIdx.x] +
                  (static_cast<int>(threadIdx.x) >= s
                       ? buf[cur][threadIdx.x - s] : 0);
    cur ^= 1;
    buf[cur][threadIdx.x] = x;
    __syncthreads();
  }
  const int incl = buf[cur][threadIdx.x];
  total = buf[cur][kScanThreads - 1];
  __syncthreads();  // the buffer is free again
  return incl - v;
}

// Pass 1: each tile's count of set rows.
__global__ void __launch_bounds__(kScanThreads)
compact_count_kernel(int cap, const unsigned char* __restrict__ mask,
                     const int* __restrict__ limit, int* __restrict__ parts) {
  const int rows = mask_rows(cap, limit);
  int total;
  block_scan(popcount16(tile_bits(mask, rows, blockIdx.x * kScanTile)),
             total);
  if (threadIdx.x == 0) parts[blockIdx.x] = total;
}

// Pass 2: each tile's offset (the counts of the tiles before it, summed by
// the block), the rows' ranks within the tile, and the set rows' indices
// written in ascending order; the last tile writes the count.
__global__ void __launch_bounds__(kScanThreads)
compact_write_kernel(int cap, const unsigned char* __restrict__ mask,
                     const int* __restrict__ limit,
                     const int* __restrict__ parts, int* __restrict__ out,
                     int* __restrict__ count) {
  const int rows = mask_rows(cap, limit);
  int before = 0;
  for (int b = threadIdx.x; b < static_cast<int>(blockIdx.x);
       b += kScanThreads) {
    before += parts[b];
  }
  int offset, total;
  block_scan(before, offset);
  const int base = blockIdx.x * kScanTile;
  const unsigned int bits = tile_bits(mask, rows, base);
  int r = offset + block_scan(popcount16(bits), total);
  const int r0 = base + static_cast<int>(threadIdx.x) * kScanItems;
  for (int k = 0; k < kScanItems; ++k) {
    if ((bits >> k) & 1u) out[r++] = r0 + k;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    *count = offset + total;
  }
}

// ---- W2 -----------------------------------------------------------------

struct Box {
  float hi[3];      // world_max
  float center[3];  // (gs / 2, gs / 2, gh / 2)
  float scale_xy;   // gh / gs (z: 1)
  float eps;
};

// One ray clipped to the world box (ops/traverse.py::aabb_clip): the
// clipped origin, the entry-face normal, tmin and ok -- B2's inputs.
struct Clip {
  float o[3], en[3], tmin;
  bool ok;
};

__device__ __forceinline__ Clip clip_ray(const Box& box, const float o[3],
                                         const float d[3]) {
  // Slab clip, entry point and entry-face normal.
  float tmin3[3], tmax3[3];
  for (int a = 0; a < 3; ++a) {
    const float t1 = (0.0f - o[a]) / d[a];
    const float t2 = (box.hi[a] - o[a]) / d[a];
    tmin3[a] = fminf(t1, t2);
    tmax3[a] = fmaxf(t1, t2);
  }
  Clip c;
  c.tmin = max_nan(clamp_min0(tmin3[0]), max_nan(tmin3[1], tmin3[2]));
  c.ok = min_nan(min_nan(tmax3[0], tmax3[1]), tmax3[2]) > c.tmin;
  const bool outside = c.tmin > 0.0f;
  float adv[3], tc[3], sg[3];
  for (int a = 0; a < 3; ++a) {
    adv[a] = o[a] + d[a] * c.tmin;
    tc[a] = fabsf(box.center[a] - adv[a]) * (a < 2 ? box.scale_xy : 1.0f);
    sg[a] = sign_of(adv[a] - box.center[a]);
  }
  const float mx = max_nan(max_nan(tc[0], tc[1]), tc[2]);
  for (int a = 0; a < 3; ++a) {
    c.en[a] = outside ? sg[a] * truncf(tc[a] / mx + 1e-6f) : 0.0f;
    c.o[a] = outside ? adv[a] - c.en[a] * box.eps : o[a];
  }
  return c;
}

// ---- W4 -----------------------------------------------------------------

constexpr int kRescueThreads = 128;

// B2's results over a trace's compacted rays, rewritten by the rescue.
struct Rescued {
  unsigned char *hit, *request, *exhausted;
  float *t, *normal, *resume;
  int* request_pos;
};

// The exhausted rays rows[j], j < *count (W0 over B2's `exhausted`),
// re-traced up to `passes` times with the escalated budget (P.max_iters),
// each pass from 2 voxels before the entry of the cell the last one
// stopped in (the prefix is known empty): the passes of the host loop
// (ops/wave.py::rescue_plain) for one ray, W2's clip and B2's walk
// (traverse_walk.inc) in their operation order.
__global__ void __launch_bounds__(kRescueThreads)
rescue_kernel(const int* __restrict__ count, const int* __restrict__ rows,
              const int* __restrict__ lanes,
              const float* __restrict__ rays_o,
              const float* __restrict__ rays_d, Box box,
              bm::TraverseParams P, int passes,
              const int* __restrict__ iv, const int* __restrict__ pool,
              const int* __restrict__ pool_base, Rescued res) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (passes <= 0 || j >= *count) return;
  const int at = rows[j];  // the ray's row in B2's results
  const int lane = lanes[at];
  float resume = res.resume[at];
  bool r_hit = false, r_request = false, exhausted = true;
  float r_t = 0.0f, r_n[3] = {0.0f, 0.0f, 0.0f};
  int r_pos[3] = {0, 0, 0};
  for (int p = 0; p < passes && exhausted; ++p) {
    const float off = clamp_min0(resume - 2.0f);
    const float d[3] = {rays_d[3 * lane], rays_d[3 * lane + 1],
                        rays_d[3 * lane + 2]};
    float o[3];
    for (int a = 0; a < 3; ++a) o[a] = rays_o[3 * lane + a] + d[a] * off;
    const Clip c = clip_ray(box, o, d);
#define BM_DIR(a) d[a]
#define BM_ORIGIN(a) c.o[a]
#define BM_OK c.ok
#define BM_ENTRY_NORMAL(a) c.en[a]
#include "traverse_walk.inc"
#undef BM_DIR
#undef BM_ORIGIN
#undef BM_OK
#undef BM_ENTRY_NORMAL
    // B2's outputs (traverse.cuh), then the pass's shift by `off`.
    const float b2_resume = bm::resume_distance(active, axis0, tx, ty, tz,
                                                ax, ay, az, bszf, c.tmin);
    r_hit = hit;
    r_t = hit ? bm::hit_distance(hit, t, c.tmin) + off : 0.0f;
    r_n[0] = hnx;
    r_n[1] = hny;
    r_n[2] = hnz;
    r_request = request;
    r_pos[0] = request ? px : 0;
    r_pos[1] = request ? py : 0;
    r_pos[2] = request ? pz : 0;
    exhausted = active;
    resume = active ? b2_resume + off : 0.0f;
  }
  res.hit[at] = r_hit;
  res.t[at] = r_t;
  store3(res.normal, at, {r_n[0], r_n[1], r_n[2]});
  res.request[at] = r_request;
  for (int a = 0; a < 3; ++a) res.request_pos[3 * at + a] = r_pos[a];
  res.exhausted[at] = exhausted;
  res.resume[at] = resume;
}

}  // namespace

extern "C" int wave_compact_launch(int cap, const unsigned char* mask,
                                   const int* limit, int* parts, int* out,
                                   int* count, void* stream) {
  if (cap > 0) {
    const int tiles = (cap + kScanTile - 1) / kScanTile;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    compact_count_kernel<<<tiles, kScanThreads, 0, s>>>(cap, mask, limit,
                                                        parts);
    compact_write_kernel<<<tiles, kScanThreads, 0, s>>>(cap, mask, limit,
                                                        parts, out, count);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wave_rescue_launch(
    int cap, const int* count, const int* rows, const int* lanes,
    const float* rays_o, const float* rays_d, float hi_x, float hi_y,
    float hi_z, float center_x, float center_y, float center_z,
    float scale_xy, float eps, const int* index_volume,
    const int* pool_words, const int* pool_base, int cells_x, int cells_y,
    int cells_z, int sc_size, int sc_xy, int num_sc, int cam_x, int cam_y,
    int cam_z, int lod8, int lod2, int brick_size, float epsilon, int budget,
    int passes, unsigned char* hit, float* t, float* normal,
    unsigned char* request, int* request_pos, unsigned char* exhausted,
    float* resume_t, void* stream) {
  const Box box{{hi_x, hi_y, hi_z}, {center_x, center_y, center_z}, scale_xy,
                eps};
  const bm::TraverseParams P{cells_x, cells_y, cells_z, sc_size, sc_xy,
                             num_sc,  cam_x,   cam_y,   cam_z,   lod8,
                             lod2,    brick_size, epsilon, budget};
  const Rescued res{hit, request, exhausted, t, normal, resume_t,
                    request_pos};
  if (cap > 0) {
    rescue_kernel<<<(cap + kRescueThreads - 1) / kRescueThreads,
                    kRescueThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        count, rows, lanes, rays_o, rays_d, box, P, passes,
        index_volume, pool_words, pool_base, res);
  }
  return static_cast<int>(cudaGetLastError());
}
