// The first design of kernels R1 and R2, kept verbatim (below the next
// blank line) as the baseline that notes/probe_torch_replay.py times the
// present brickmap_tpu_torch/csrc/replay.cu against, in turns, with the L2
// cold.
// Same launchers and ctypes signatures; built with the port's nvcc flags.

// Kernels R1 and R2: the sparse replay's slice body around B4f/B4b, so that
// a slice of the training step runs R1 -> B4f -> R2 -> B4b, four launches.
//
// They have no Pallas twin: the JAX package's _row_chunk_grad
// (brickmap_tpu/diff/sparse.py:490) leaves both to XLA, which fuses them
// into the one program of _row_scan_grads' lax.scan (:535).
//   R1 segment_geom_kernel  _segment_geom (:141) with _merge_offsets (:41)
//                           and the -1 poison of the invalid steps (:514):
//                           a segment's pool slot and the in-brick DDA's
//                           visited voxels, B4f's and B4b's inputs.
//   R2 composite_kernel     the clip/mask chain and _composite_core3 (:293)
//                           with its division-free custom VJP (:312-339)
//                           under value_and_grad of the SSE (:525-530): each
//                           ray's SSE and the cotangents of its visited
//                           voxels' values, which B4b adds into the field.
// The plain versions are brickmap_tpu_torch/ops/replay.py; each kernel
// rounds every operation as that torch code does (-fmad=false, no fast
// math, IEEE division) and equals it bit for bit.
//
// R1, one thread per segment (row r = c*K + k of the C*K segments).  What
// bounds it: neither much.  A segment reads 12 bytes of record, a 4-byte
// cellmap word and its ray's 36 bytes, and writes 92 bytes (14.7 MB for a
// 16,384-ray slice at K = 8, 0.0044 ms at 3.35 TB/s); its rank tables take
// 3 x 21 ranks of two crossing counts (a division each) and 3 x 22 binary
// searches of 5 steps, ~2,300 operations (also ~0.004 ms at 67 TFLOP/s).
// The design: merge_offsets' binary search is kept step for step, so the
// offsets equal it even where a count saturates, but over a table of the
// 22 ranks of one axis built once (shared memory, one column a thread, no
// bank conflicts) instead of two counts at each of the 5 x 22 probes; the
// 22 voxel ids build up in registers over the three axes and are written
// once.  The [C, K] record arrays are read through their row stride (the
// replay's slices are column cuts of [N, K_max] arrays), with no copy.
//
// R2, one thread per ray.  What bounds it: bytes, B4f's values read, the
// cotangents written, lin2 read (104 MB for a 16,384-ray slice at K = 8,
// 0.031 ms); ~30 float operations a step.  The design: a forward loop over
// the ray's V = K*nvox steps in order (the transmittance, the colour sums)
// and a reverse loop (the suffix S, the cotangents), sequential per ray so
// that every sum is taken in the plain version's order.  Exact at occ == 1:
// the forward pass keeps T^excl_i in the occupancy slot of dvals, and the
// reverse pass reads it there and overwrites it with the gradient (no
// division by T).  A masked step (lin2 < 0) composites as occ = 0, which
// leaves T exactly as it was, and gets a zero occupancy cotangent.  The
// clip passes half the cotangent at x == 0 or 1, as jnp.clip and
// torch.maximum/minimum do.  One thread a ray underfills the card (16,384
// threads, ~4 warps an SM) and each warp's loads touch 32 rows 2.8 KB
// apart; staging a warp's rows through shared memory is later work.
//
// Built by brickmap_tpu_torch/kernels/build.py (nvcc, sm_90a, -fmad=false);
// bound with ctypes by brickmap_tpu_torch/kernels/replay.py.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kBrick = 8;              // voxels per brick edge
constexpr int kNvox = 3 * kBrick - 2;  // steps of the in-brick DDA: 22
constexpr int kNj = kNvox - 1;         // crossings an axis can make: 21
constexpr int kSearchSteps = 5;        // (kNj + 1).bit_length()
constexpr int kRankNone = 1 << 30;     // rank of a crossing that is none
constexpr float kTie = 1e-3f;          // merge_offsets' absolute tie window
constexpr int kGeomThreads = 128;
constexpr int kCompThreads = 128;

// torch.sign of a float, as the float -1, 0 or 1.
__device__ __forceinline__ float sign_of(float d) {
  return static_cast<float>((0.0f < d) - (d < 0.0f));
}

// merge_offsets' count(b, t, inclusive): crossings of axis b before time t
// (at or before with `inclusive`), within the tie window of t counted as
// equal, clipped to [0, kNj].  The +1 wraps as torch's int32 add does when
// the conversion saturates.
__device__ __forceinline__ int crossings(float t, float tmax, float db,
                                         float e, bool has, bool inclusive) {
  const float r = (t - tmax) / db;
  int n;
  if (inclusive) {
    n = static_cast<int>(
        static_cast<unsigned int>(static_cast<int>(floorf(r + e))) + 1u);
  } else {
    n = static_cast<int>(ceilf(r - e));
  }
  n = has ? n : 0;
  return min(max(n, 0), kNj);
}

__global__ void __launch_bounds__(kGeomThreads)
segment_geom_kernel(int rows, int keff, const float* __restrict__ oc,
                    const float* __restrict__ dc,
                    const float* __restrict__ enorm,
                    const int* __restrict__ cells, int cells_ld,
                    const float* __restrict__ nd, int nd_ld,
                    const int* __restrict__ ncode, int ncode_ld,
                    const int* __restrict__ cellmap, int cy, int cx,
                    int ncell, float eps, int* __restrict__ slots,
                    int* __restrict__ lin2) {
  __shared__ int rank_tab[kNvox][kGeomThreads];
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= rows) return;
  const int r = static_cast<int>(e);
  const int ray = r / keff;
  const int k = r - ray * keff;
  const int cell = __ldg(cells + static_cast<long long>(ray) * cells_ld + k);
  const float ndv = __ldg(nd + static_cast<long long>(ray) * nd_ld + k);
  const int nc = __ldg(ncode + static_cast<long long>(ray) * ncode_ld + k);

  // The segment's brick slot.
  const int cxp = cell & 0x3FF;
  const int cyp = (cell >> 10) & 0x3FF;
  const int czp = (cell >> 20) & 0x3FF;
  const int flat = min(max((czp * cy + cyp) * cx + cxp, 0), ncell - 1);
  const int slot = __ldg(cellmap + flat);
  const bool valid = cell >= 0 && slot >= 0;
  slots[r] = valid ? slot : 0;

  // The in-brick DDA from the nudged entry point (voxel.cuh:224): crossing
  // times in the global frame of `so`, the position reduced to the brick
  // by C's trunc-mod (voxel.cuh:93).
  float tmax[3], tdelta[3], db[3], tie[3];
  int p[3], stepv[3];
  bool has[3];
  const long long base = 3LL * ray;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float d = __ldg(dc + base + a);
    const float nrm = nc >= 0 ? (nc == a ? -sign_of(d) : 0.0f)
                              : __ldg(enorm + base + a);
    const float so = (__ldg(oc + base + a) + d * ndv) * 8.0f - nrm * eps;
    const int pg = static_cast<int>(truncf(so));
    stepv[a] = (0.0f < d) - (d < 0.0f);
    const float rd = d == 0.0f ? 0.0f : 1.0f / d;
    const float cb = d > 0.0f ? static_cast<float>(pg) + 1.0f
                              : static_cast<float>(pg);
    tmax[a] = d != 0.0f ? (cb - so) * rd : 1e6f;
    p[a] = pg % kBrick;
    tdelta[a] = fabsf(rd);
    has[a] = d != 0.0f;
    db[a] = tdelta[a] == 0.0f ? 1.0f : tdelta[a];
    tie[a] = kTie / db[a];
  }

  // merge_offsets: per axis, the ranks of its 21 crossings in the 3-way
  // merge (ties z over y over x), then offs[k] = #{j : rank(j) < k} by the
  // same 5-step binary search; each step's voxel id adds up over the axes.
  int lin[kNvox];
  unsigned int inb = (1u << kNvox) - 1u;
#pragma unroll
  for (int s = 0; s < kNvox; ++s) lin[s] = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int b0 = a == 0 ? 1 : 0;
    const int b1 = a == 2 ? 1 : 2;
    for (int j = 0; j < kNj; ++j) {
      int rank = kRankNone;
      if (has[a]) {
        const float t = tmax[a] + static_cast<float>(j) * tdelta[a];
        rank = j +
               crossings(t, tmax[b0], db[b0], tie[b0], has[b0], b0 > a) +
               crossings(t, tmax[b1], db[b1], tie[b1], has[b1], b1 > a);
      }
      rank_tab[j][threadIdx.x] = rank;
    }
    rank_tab[kNj][threadIdx.x] = kRankNone;
    const int scale = a == 0 ? 1 : (a == 1 ? kBrick : kBrick * kBrick);
#pragma unroll
    for (int s = 0; s < kNvox; ++s) {
      int lo = 0, hi = kNj;
#pragma unroll
      for (int it = 0; it < kSearchSteps; ++it) {
        const int mid = (lo + hi) >> 1;
        const bool below = rank_tab[mid][threadIdx.x] < s;
        lo = below ? mid + 1 : lo;
        hi = below ? hi : mid;
      }
      const int pk = p[a] + stepv[a] * lo;
      if (pk < 0 || pk >= kBrick) inb &= ~(1u << s);
      lin[s] += pk * scale;
    }
  }
  int* out = lin2 + static_cast<long long>(r) * kNvox;
#pragma unroll
  for (int s = 0; s < kNvox; ++s) {
    out[s] = valid && ((inb >> s) & 1u) ? lin[s] : -1;
  }
}

// The step's composited occupancy: clip(x, 0, 1) where valid, else 0.
__device__ __forceinline__ float occupancy(float x, bool valid) {
  const float lo = x < 0.0f ? 0.0f : x;
  return valid ? (lo > 1.0f ? 1.0f : lo) : 0.0f;
}

__global__ void __launch_bounds__(kCompThreads)
composite_kernel(int c, int keff, int nvox, const float* __restrict__ vals,
                 const int* __restrict__ lin2, const float* __restrict__ bg,
                 const float* __restrict__ tgt, float* __restrict__ sse,
                 float* __restrict__ dvals) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= c) return;
  const int ray = static_cast<int>(e);
  const long long row0 = static_cast<long long>(ray) * keff;
  const int width = 4 * nvox;

  // Forward: T^excl into dvals' occupancy slot, the colour sums in order.
  float trans = 1.0f, acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  for (int k = 0; k < keff; ++k) {
    const float* v = vals + (row0 + k) * width;
    const int* l = lin2 + (row0 + k) * nvox;
    float* dv = dvals + (row0 + k) * width;
    for (int j = 0; j < nvox; ++j) {
      const float o = occupancy(v[j], l[j] >= 0);
      dv[j] = trans;
      const float w = o * trans;
      acc0 = acc0 + w * v[nvox + j];
      acc1 = acc1 + w * v[2 * nvox + j];
      acc2 = acc2 + w * v[3 * nvox + j];
      trans = trans * (1.0f - o);
    }
  }
  const float b0 = bg[3 * ray], b1 = bg[3 * ray + 1], b2 = bg[3 * ray + 2];
  const float d0 = (acc0 + trans * b0) - tgt[3 * ray];
  const float d1 = (acc1 + trans * b1) - tgt[3 * ray + 1];
  const float d2 = (acc2 + trans * b2) - tgt[3 * ray + 2];
  sse[ray] = (d0 * d0 + d1 * d1) + d2 * d2;

  // Backward of the SSE: drgb = 2 (rgb - target), the suffix from
  // S_V = bg . drgb back to the first step.
  const float g0 = 2.0f * d0, g1 = 2.0f * d1, g2 = 2.0f * d2;
  float suffix = (b0 * g0 + b1 * g1) + b2 * g2;
  for (int k = keff - 1; k >= 0; --k) {
    const float* v = vals + (row0 + k) * width;
    const int* l = lin2 + (row0 + k) * nvox;
    float* dv = dvals + (row0 + k) * width;
    for (int j = nvox - 1; j >= 0; --j) {
      const float x = v[j];
      const bool valid = l[j] >= 0;
      const float o = occupancy(x, valid);
      const float t_excl = dv[j];
      const float s = (v[nvox + j] * g0 + v[2 * nvox + j] * g1) +
                      v[3 * nvox + j] * g2;
      const float d_occ = t_excl * (s - suffix);
      suffix = o * s + (1.0f - o) * suffix;
      const float w = o * t_excl;
      dv[nvox + j] = w * g0;
      dv[2 * nvox + j] = w * g1;
      dv[3 * nvox + j] = w * g2;
      const float d_x = (x == 0.0f || x == 1.0f)   ? d_occ * 0.5f
                        : (x < 0.0f || x > 1.0f) ? 0.0f
                                                 : d_occ;
      dv[j] = valid ? d_x : 0.0f;
    }
  }
}

int blocks_for(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

}  // namespace

extern "C" int replay_geom_launch(int rows, int keff, const float* oc,
                                  const float* dc, const float* enorm,
                                  const int* cells, int cells_ld,
                                  const float* nd, int nd_ld,
                                  const int* ncode, int ncode_ld,
                                  const int* cellmap, int cy, int cx,
                                  int ncell, float eps, int* slots,
                                  int* lin2, void* stream) {
  if (rows > 0) {
    segment_geom_kernel<<<blocks_for(rows, kGeomThreads), kGeomThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        rows, keff, oc, dc, enorm, cells, cells_ld, nd, nd_ld, ncode,
        ncode_ld, cellmap, cy, cx, ncell, eps, slots, lin2);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int replay_composite_launch(int c, int keff, int nvox,
                                       const float* vals, const int* lin2,
                                       const float* bg, const float* tgt,
                                       float* sse, float* dvals,
                                       void* stream) {
  if (c > 0) {
    composite_kernel<<<blocks_for(c, kCompThreads), kCompThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        c, keff, nvox, vals, lin2, bg, tgt, sse, dvals);
  }
  return static_cast<int>(cudaGetLastError());
}
