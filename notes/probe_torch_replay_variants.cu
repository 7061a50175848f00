// The variants of kernels R1 and R2 that notes/probe_torch_replay.py times
// and that were not shipped: brickmap_tpu_torch/csrc/replay.cu's design
// (below the next blank line) with two more build-time knobs,
// BM_R1_MIN_BLOCKS (R1's minimum of blocks an SM for ptxas) and
// BM_R2_STAGES (R2's stages of rows in flight, its pipeline written for
// any count).  At their defaults, 6 and 2, it is the shipped design.  Same
// launchers and ctypes signatures; built with the port's nvcc flags.

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
// 16,384-ray slice at K = 8, 0.0044 ms at 3.35 TB/s); merge_offsets' rank
// tables take two crossing counts (an IEEE division each) a rank.  The
// design: per axis, offs[s] = #{j : rank(j) < s}.  Where no crossing count
// of the axis can saturate its int32 conversion (checked at the axis' first
// and last crossing: the counts are monotone in j in between), the ranks
// strictly increase, so the ranks below 21 are found in order and stop at
// the first that is not, each sets a bit, and offs[s] is a popcount: about
// 24 ranks a segment instead of 63, and no search.  Elsewhere (a direction
// component near 0 with far crossings: the count's +1 wraps after the
// conversion saturates and the ranks are not monotone) the axis keeps
// merge_offsets' 5-step binary search over a shared table of its 21 ranks,
// step for step, so the offsets equal it there too.  The 22 voxel ids build
// up in registers over the three axes, and a block's rows leave through
// the shared table, coalesced.  The [C, K] record arrays are read through
// their row stride (the replay's slices are column cuts of [N, K_max]
// arrays), with no copy.
//
// R2, one warp per 32 rays, a lane a ray.  What bounds it: bytes, B4f's
// values read, the cotangents written, lin2 read (104 MB for a 16,384-ray
// slice at K = 8, 0.031 ms); ~30 float operations a step.  Each lane runs
// the forward loop over its ray's V = K*nvox steps in order (the
// transmittance, the colour sums) and the reverse loop (the suffix S, the
// cotangents), so that every sum is taken in the plain version's order.
// The loads and stores go through shared memory: the warp copies its 32
// rays' rows of segment k (352 B of vals, 88 B of lin2 each) with cp.async,
// 16 and 8 bytes a lane on consecutive addresses, into a stage of rows 92
// floats apart (23 16-byte chunks, so that the lanes' 16-byte reads of
// their own rows fall on distinct banks), while segment k - 1 (forward) or
// k + 1 (reverse) is composited from the other stage; each lane takes its
// row into registers with 16-byte reads.  The forward pass keeps, a lane
// and segment, T^excl at the segment's start and the 22 valid bits in
// shared memory; the reverse pass recomputes the segment's T^excl from
// there with the forward's own multiplies (exact at occ == 1, no division)
// and needs no lin2.  It fetches vals again (mostly from the L2), all but
// the forward's last two segments, which are still staged; it writes its
// cotangents over the staged row, and the warp stores the 32 rows
// coalesced.  31,232 B of shared memory a warp at K = 8: seven resident an
// SM, more than a slice's 512 warps need.  A masked step (lin2 < 0) composites
// as occ = 0, which leaves T exactly as it was, and gets a zero occupancy
// cotangent.  The clip passes half the cotangent at x == 0 or 1, as
// jnp.clip and torch.maximum/minimum do.
//
// Built by notes/probe_torch_replay.py with -D of the macros below.

#include <cuda_runtime.h>

#include <math.h>
#include <string.h>

// R1's merge: 0 the sweep where exact, else the search; 1 the search on
// every axis (the first design's algorithm); 2 the sweep on every axis, wrong where the
// ranks wrap (a check that the host test's segments reach the search).
#ifndef BM_R1_MERGE
#define BM_R1_MERGE 0
#endif
// R1's minimum of blocks an SM for ptxas: 6 lets it fit 64 registers with no
// spill, so 8 blocks are resident and a 16,384-ray slice's 1,024 blocks run
// in one wave (8 itself spills; 1, 69 registers, leaves 7 resident).
#ifndef BM_R1_MIN_BLOCKS
#define BM_R1_MIN_BLOCKS 6
#endif
// R2's stages of rows in flight a warp (2: double buffering).
#ifndef BM_R2_STAGES
#define BM_R2_STAGES 2
#endif

namespace {

constexpr int kBrick = 8;              // voxels per brick edge
constexpr int kNvox = 3 * kBrick - 2;  // steps of the in-brick DDA: 22
constexpr int kNj = kNvox - 1;         // crossings an axis can make: 21
constexpr int kSearchSteps = 5;        // (kNj + 1).bit_length()
constexpr int kRankNone = 1 << 30;     // rank of a crossing that is none
constexpr float kTie = 1e-3f;          // merge_offsets' absolute tie window
constexpr int kGeomThreads = 128;

constexpr int kWarp = 32;              // R2: rays a warp, a block
constexpr int kValsW = 4 * kNvox;      // floats of a vals row: 88
constexpr int kChunks = kValsW / 4;    // its 16-byte chunks: 22
constexpr int kPairs = kNvox / 2;      // a lin2 row's 8-byte pairs: 11
constexpr int kRowF = kValsW + 4;      // a staged vals row's stride: 92
constexpr int kStageF = kWarp * (kRowF + kNvox);  // a stage, in 4 B words
constexpr int kStages = BM_R2_STAGES;

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

// Whether no count of axis b's crossings at times t0..t1 can saturate: then
// |r| <= 2^30 and the tie window is below 2^29, so floor(r + e) and
// ceil(r - e) convert exactly and the +1 cannot wrap.  False for NaN.
__device__ __forceinline__ bool counts_exact(float t0, float t1, float tmax,
                                             float db, float e) {
  const float lim = 0x1p30f * db;
  return fabsf(t0 - tmax) < lim && fabsf(t1 - tmax) < lim && e < 0x1p29f;
}

__global__ void __launch_bounds__(kGeomThreads, BM_R1_MIN_BLOCKS)
segment_geom_kernel(int rows, int keff, const float* __restrict__ oc,
                    const float* __restrict__ dc,
                    const float* __restrict__ enorm,
                    const int* __restrict__ cells, int cells_ld,
                    const float* __restrict__ nd, int nd_ld,
                    const int* __restrict__ ncode, int ncode_ld,
                    const int* __restrict__ cellmap, int cy, int cx,
                    int ncell, float eps, int* __restrict__ slots,
                    int* __restrict__ lin2) {
  // A thread's column: an axis' ranks for the search, then its output row.
  // One int of padding a row keeps both the columns and the block's
  // row-major copy-out free of bank conflicts.
  __shared__ int tab[kNvox][kGeomThreads + 1];
  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * kGeomThreads;
  if (first + tid < rows) {
    const int r = static_cast<int>(first + tid);
    const int ray = r / keff;
    const int k = r - ray * keff;
    const int cell =
        __ldg(cells + static_cast<long long>(ray) * cells_ld + k);
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

    // The in-brick DDA from the nudged entry point (voxel.cuh:224):
    // crossing times in the global frame of `so`, the position reduced to
    // the brick by C's trunc-mod (voxel.cuh:93).
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

    // merge_offsets: the rank of axis a's j-th crossing in the 3-way merge
    // (ties z over y over x) is j plus the other axes' crossings before it;
    // offs[s] = #{j : rank(j) < s}; each step's voxel id adds up over the
    // axes, two ids to a register (16 bits each: an out-of-brick step's
    // coordinate is clamped into the brick, its id is not written).
    unsigned int lin[kNvox / 2];
    unsigned int inb = (1u << kNvox) - 1u;
#pragma unroll
    for (int s = 0; s < kNvox / 2; ++s) lin[s] = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int b0 = a == 0 ? 1 : 0;
      const int b1 = a == 2 ? 1 : 2;
      const float ta = tmax[a], da = tdelta[a];
      const float tm0 = tmax[b0], db0 = db[b0], tie0 = tie[b0];
      const float tm1 = tmax[b1], db1 = db[b1], tie1 = tie[b1];
      const bool has0 = has[b0], has1 = has[b1];
      auto rank = [=](int j) {
        const float t = ta + static_cast<float>(j) * da;
        return j + crossings(t, tm0, db0, tie0, has0, b0 > a) +
               crossings(t, tm1, db1, tie1, has1, b1 > a);
      };
      const float t0 = ta + static_cast<float>(0) * da;
      const float t1 = ta + static_cast<float>(kNj - 1) * da;
      // Without a crossing (every rank none) the search finds 0 at every
      // step, as the sweep does with no bit set.
      const bool search =
          has[a] &&
          (BM_R1_MERGE == 1 ||
           (BM_R1_MERGE == 0 &&
            !((!has0 || counts_exact(t0, t1, tm0, db0, tie0)) &&
              (!has1 || counts_exact(t0, t1, tm1, db1, tie1)))));
      unsigned int below = 0;
      if (search) {
        for (int j = 0; j < kNj; ++j) tab[j][tid] = rank(j);
        tab[kNj][tid] = kRankNone;
      } else if (has[a]) {
        // The ranks strictly increase: those below kNj set their bits.
        for (int j = 0; j < kNj; ++j) {
          const int rk = rank(j);
          if (rk >= kNj) break;
          below |= 1u << rk;
        }
      }
      const int scale = a == 0 ? 1 : (a == 1 ? kBrick : kBrick * kBrick);
#pragma unroll
      for (int s = 0; s < kNvox; ++s) {
        int offs = __popc(below & ((1u << s) - 1u));
        if (search) {
          int lo = 0, hi = kNj;
#pragma unroll
          for (int it = 0; it < kSearchSteps; ++it) {
            const int mid = (lo + hi) >> 1;
            const bool lower = tab[mid][tid] < s;
            lo = lower ? mid + 1 : lo;
            hi = lower ? hi : mid;
          }
          offs = lo;
        }
        const int pk = p[a] + stepv[a] * offs;
        if (pk < 0 || pk >= kBrick) inb &= ~(1u << s);
        lin[s >> 1] += static_cast<unsigned int>(
                           min(max(pk, 0), kBrick - 1) * scale)
                       << (16 * (s & 1));
      }
    }
#pragma unroll
    for (int s = 0; s < kNvox; ++s) {
      tab[s][tid] = valid && ((inb >> s) & 1u)
                        ? static_cast<int>((lin[s >> 1] >> (16 * (s & 1))) &
                                           0xFFFFu)
                        : -1;
    }
  }
  __syncthreads();
  // The block's rows are consecutive in lin2: copy them out row-major.
  const int n =
      static_cast<int>(min(rows - first, static_cast<long long>(kGeomThreads)))
      * kNvox;
  int* out = lin2 + first * kNvox;
  for (int i = tid; i < n; i += kGeomThreads) {
    const int row = i / kNvox;
    out[i] = tab[i - row * kNvox][row];
  }
}

// cp.async of 16 (8) bytes from device to shared memory, and its group
// commit and wait; in the host build a plain copy, complete at once.
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned int>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void copy8_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<unsigned int>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
#else
  memcpy(dst, src, 8);
#endif
}

__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most kStages - 1 of this thread's groups are in flight.
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
#endif
}

// The step's composited occupancy: clip(x, 0, 1) where valid, else 0.
__device__ __forceinline__ float occupancy(float x, bool valid) {
  const float lo = x < 0.0f ? 0.0f : x;
  return valid ? (lo > 1.0f ? 1.0f : lo) : 0.0f;
}

// A staged row (kChunks 16-byte chunks) into registers, and back.
__device__ __forceinline__ void load_row(const float* row,
                                         float (&v)[kValsW]) {
  const float4* q = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 t = q[c];
    v[4 * c] = t.x;
    v[4 * c + 1] = t.y;
    v[4 * c + 2] = t.z;
    v[4 * c + 3] = t.w;
  }
}

__device__ __forceinline__ void store_row(float* row,
                                          const float (&v)[kValsW]) {
  float4* q = reinterpret_cast<float4*>(row);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    q[c] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  }
}

// Shared memory of R2's block, in bytes: kStages stages (32 vals rows of
// kRowF floats, then 32 lin2 rows of kNvox ints), then T^excl at each
// segment's start and the valid bits, [keff][32] each.
int composite_smem(int keff) {
  return 4 * (kStages * kStageF + 2 * kWarp * keff);
}

__global__ void __launch_bounds__(kWarp)
composite_kernel(int c, int keff, const float* __restrict__ vals,
                 const int* __restrict__ lin2, const float* __restrict__ bg,
                 const float* __restrict__ tgt, float* __restrict__ sse,
                 float* __restrict__ dvals) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const int ray0 = blockIdx.x * kWarp;
  const int ray = ray0 + lane;
  const bool active = ray < c;
  const int nrays = min(kWarp, c - ray0);
  float* const t_start = smem + kStages * kStageF;
  unsigned int* const valid_bits =
      reinterpret_cast<unsigned int*>(t_start + keff * kWarp);
  auto stage = [&](int k) { return smem + (k % kStages) * kStageF; };
  auto row_of = [&](int row, int k) {
    return (static_cast<long long>(ray0 + row) * keff + k);
  };

  // Segment k's rows of the warp's rays (and their lin2 rows) into its
  // stage, one commit group; lanes on consecutive 16- (8-) byte pieces.
  auto fetch = [&](int k, bool with_lin) {
    float* sv = stage(k);
#pragma unroll
    for (int it = 0; it < kChunks; ++it) {
      const int i = it * kWarp + lane;
      const int row = i / kChunks;
      const int ch = i - row * kChunks;
      if (row < nrays) {
        copy16_async(sv + row * kRowF + 4 * ch,
                     vals + row_of(row, k) * kValsW + 4 * ch);
      }
    }
    if (with_lin) {
      int* sl = reinterpret_cast<int*>(sv + kWarp * kRowF);
#pragma unroll
      for (int it = 0; it < kPairs; ++it) {
        const int i = it * kWarp + lane;
        const int row = i / kPairs;
        const int pr = i - row * kPairs;
        if (row < nrays) {
          copy8_async(sl + row * kNvox + 2 * pr,
                      lin2 + row_of(row, k) * kNvox + 2 * pr);
        }
      }
    }
    copy_commit();
  };

  // Forward: T^excl at each segment's start, the valid bits, the colour
  // sums in order.  Segment k + kStages - 1 is in flight while k runs.
  float trans = 1.0f, acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < keff) {
      fetch(k, true);
    } else {
      copy_commit();
    }
  }
  for (int k = 0; k < keff; ++k) {
    if (k + kStages - 1 < keff) {
      fetch(k + kStages - 1, true);
    } else {
      copy_commit();
    }
    copy_wait();
    __syncwarp();
    if (active) {
      float v[kValsW];
      load_row(stage(k) + lane * kRowF, v);
      const int2* lq = reinterpret_cast<const int2*>(stage(k) +
                                                     kWarp * kRowF) +
                       lane * kPairs;
      unsigned int bits = 0;
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int2 t = lq[q];
        bits |= static_cast<unsigned int>(t.x >= 0) << (2 * q);
        bits |= static_cast<unsigned int>(t.y >= 0) << (2 * q + 1);
      }
      t_start[k * kWarp + lane] = trans;
#pragma unroll
      for (int j = 0; j < kNvox; ++j) {
        const float o = occupancy(v[j], (bits >> j) & 1u);
        const float w = o * trans;
        acc0 = acc0 + w * v[kNvox + j];
        acc1 = acc1 + w * v[2 * kNvox + j];
        acc2 = acc2 + w * v[3 * kNvox + j];
        trans = trans * (1.0f - o);
      }
      valid_bits[k * kWarp + lane] = bits;
    }
    __syncwarp();
  }

  // The SSE, and its backward: drgb = 2 (rgb - target), the suffix from
  // S_V = bg . drgb back to the first step.
  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, suffix = 0.0f;
  if (active) {
    const float b0 = bg[3 * ray], b1 = bg[3 * ray + 1], b2 = bg[3 * ray + 2];
    const float d0 = (acc0 + trans * b0) - tgt[3 * ray];
    const float d1 = (acc1 + trans * b1) - tgt[3 * ray + 1];
    const float d2 = (acc2 + trans * b2) - tgt[3 * ray + 2];
    sse[ray] = (d0 * d0 + d1 * d1) + d2 * d2;
    g0 = 2.0f * d0;
    g1 = 2.0f * d1;
    g2 = 2.0f * d2;
    suffix = (b0 * g0 + b1 * g1) + b2 * g2;
  }

  // Reverse, segment K - 1 down to 0, with segment k - kStages + 1 in
  // flight: the cotangents over the staged row, then the warp's rows out to
  // dvals.  The forward pass' last kStages segments are still staged.
  auto refetch = [&](int k) {
    if (k >= 0 && k < keff - kStages) {
      fetch(k, false);
    } else {
      copy_commit();
    }
  };
  for (int k = 1; k < kStages - 1; ++k) refetch(keff - 1 - k);
  for (int k = keff - 1; k >= 0; --k) {
    refetch(k - (kStages - 1));
    copy_wait();
    __syncwarp();
    float* const sv = stage(k);
    if (active) {
      float v[kValsW];
      load_row(sv + lane * kRowF, v);
      const unsigned int bits = valid_bits[k * kWarp + lane];
      // The segment's T^excl, as the forward pass made them.
      float te[kNvox];
      float tt = t_start[k * kWarp + lane];
#pragma unroll
      for (int j = 0; j < kNvox; ++j) {
        te[j] = tt;
        tt = tt * (1.0f - occupancy(v[j], (bits >> j) & 1u));
      }
#pragma unroll
      for (int j = kNvox - 1; j >= 0; --j) {
        const float x = v[j];
        const bool valid = (bits >> j) & 1u;
        const float o = occupancy(x, valid);
        const float t_excl = te[j];
        const float s = (v[kNvox + j] * g0 + v[2 * kNvox + j] * g1) +
                        v[3 * kNvox + j] * g2;
        const float d_occ = t_excl * (s - suffix);
        suffix = o * s + (1.0f - o) * suffix;
        const float w = o * t_excl;
        v[kNvox + j] = w * g0;
        v[2 * kNvox + j] = w * g1;
        v[3 * kNvox + j] = w * g2;
        const float d_x = (x == 0.0f || x == 1.0f)   ? d_occ * 0.5f
                          : (x < 0.0f || x > 1.0f) ? 0.0f
                                                   : d_occ;
        v[j] = valid ? d_x : 0.0f;
      }
      store_row(sv + lane * kRowF, v);
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < kChunks; ++it) {
      const int i = it * kWarp + lane;
      const int row = i / kChunks;
      const int ch = i - row * kChunks;
      if (row < nrays) {
        *reinterpret_cast<float4*>(dvals + row_of(row, k) * kValsW +
                                   4 * ch) =
            *reinterpret_cast<const float4*>(sv + row * kRowF + 4 * ch);
      }
    }
    __syncwarp();
  }
}

int blocks_for(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

// Above the default 48 KB a block, R2's dynamic shared memory must be
// allowed first.
cudaError_t allow_composite_smem(int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(composite_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
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
  if (nvox != kNvox) return static_cast<int>(cudaErrorInvalidValue);
  if (c > 0) {
    const int smem = composite_smem(keff);
    const cudaError_t err = allow_composite_smem(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    composite_kernel<<<blocks_for(c, kWarp), kWarp, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        c, keff, vals, lin2, bg, tgt, sse, dvals);
  }
  return static_cast<int>(cudaGetLastError());
}

// Each kernel's launch shape at K = keff, for the checks on the card:
// threads a block, dynamic shared memory bytes and blocks resident on an
// SM; R1 in out[0..2], R2 in out[3..5].
extern "C" int replay_launch_shape(int keff, int* out) {
  const int smem = composite_smem(keff);
  cudaError_t err = allow_composite_smem(smem);
  out[0] = kGeomThreads;
  out[1] = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 2, segment_geom_kernel, kGeomThreads, 0);
  }
  out[3] = kWarp;
  out[4] = smem;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 5, composite_kernel, kWarp, smem);
  }
  return static_cast<int>(err);
}
