// Probe builds of kernel B2 (csrc/traverse.cu) for notes/probe_torch_b2.py:
// where each top step finds its index word and how a descend reads its
// brick's 64-byte row, chosen at compile time.
//
//   PROBE_TOP 0: index_volume[cz][cy][cx] (the baseline design);
//             1: block_words, the address recomputed from the cell at
//                every top step;
//             2: block_words, the address advanced by the step's change
//                of each axis's term (the old cell kept through the step).
//   PROBE_ROW 0: the row's word re-read from global memory at every step
//                of the sub-DDA (the baseline design);
//             1: the row fetched once per descend with four 16-byte
//                ld.global.nc into the thread's shared-memory slot (17
//                words, so that the slots of a warp's lanes fall on
//                distinct banks), the sub-DDA reading the slot;
//             2: the current 32-bit word kept in a register and reloaded
//                only when lin >> 5 changes.
//   PROBE_PAD 1: row mode 0 with row mode 1's shared memory reserved and
//                not used (the L1 it takes, alone).
//   PROBE_CLOCK 1: the PROBE_TOP 0 / PROBE_ROW 0 kernel with clock64()
//                stamps: each thread's cycles from start to end, the cycles
//                from issuing each index-word load and each row-word load
//                to the first use of its value, and the cycles inside the
//                descends (from the pool base's load to the sub-DDA's
//                end), summed over threads into counters[0-3], with the
//                load and descend counts in counters[4-6].
//   PROBE_COUNT 1: the PROBE_TOP 0 / PROBE_ROW 0 kernel that also counts,
//                for each warp-wide gather, the distinct 128-byte lines its
//                active lanes touch (__match_any_sync on the line, the
//                leaders counted): index words at both layouts' addresses,
//                the sub-DDA's per-step row words, and the rows a descend
//                would fetch whole; and, in bitmaps after the counters,
//                every 128-byte line and 32-byte sector of index words that
//                any lane read, at both layouts' addresses (the footprint
//                the L2 has to hold).
//
//   variant_launch(n, rays..., index_volume, block_words, pool, base,
//                  grid ints..., eps, max_iters, outputs..., counters,
//                  blocks_per_sm, stream)
//
// blocks_per_sm > 0 launches the same body as a grid-stride loop over at
// most that many blocks of 128 an SM (no shared memory is reserved for
// it, so the L1's size does not change with the cap).

#include <cuda_runtime.h>

#include "dda.cuh"

#ifndef PROBE_TOP
#define PROBE_TOP 1
#endif
#ifndef PROBE_ROW
#define PROBE_ROW 1
#endif
#ifndef PROBE_COUNT
#define PROBE_COUNT 0
#endif
#ifndef PROBE_PAD
#define PROBE_PAD 0  // 1: reserve the shared slots of row mode 1, unused
#endif
#ifndef PROBE_CLOCK
#define PROBE_CLOCK 0
#endif
#if (PROBE_COUNT || PROBE_CLOCK) && (PROBE_TOP != 0 || PROBE_ROW != 0)
#error "the counting and clock builds follow the baseline design's reads"
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kSlot = 17;  // shared words a thread (16 + 1 of padding)
constexpr unsigned int kFlagBits = 0xE0000000u;
constexpr unsigned int kLoadedBit = 0x80000000u;
constexpr unsigned int kUnloadedBit = 0x40000000u;

struct Params {
  int cx, cy, cz;
  int sc, sc_xy, num_sc;
  int cam_x, cam_y, cam_z;
  int lod8, lod2;
  int bsz;
  float eps;
  int max_iters;
  int bw_y, bw_z;  // block_words words per row (y) and layer (z) of blocks
};

// The block_words address of a cell is separable: x's term + y's + z's.
__device__ __forceinline__ int xterm(int p) { return p + 60 * (p >> 2); }
__device__ __forceinline__ int yterm(int p, int bw_y) {
  return 4 * p + (bw_y - 16) * (p >> 2);
}
__device__ __forceinline__ int zterm(int p, int bw_z) {
  return 16 * p + (bw_z - 64) * (p >> 2);
}

#if PROBE_COUNT
// counters, 4 a kind (warp gathers, lines, lines at the second address,
// active lanes): [0-3] index words at index_volume's and block_words'
// addresses; [4-7] the sub-DDA's per-step row words; [8-11] descends, the
// lines of the whole rows.  Then four bitmaps (u32 words, each
// footprint_words long): the lines and sectors of index_volume and of
// block_words that were read.
__device__ __forceinline__ void mark(unsigned int* bits, long long unit) {
  atomicOr(bits + (unit >> 5), 1u << (unit & 31));
}

__device__ __forceinline__ void count_lines(unsigned long long* c,
                                            unsigned long long a0,
                                            unsigned long long a1,
                                            bool two) {
  const unsigned m = __activemask();
  const int lane = threadIdx.x & 31;
  const unsigned s0 = __match_any_sync(m, a0 >> 7);
  const unsigned l0 = __ballot_sync(m, __ffs(s0) - 1 == lane);
  unsigned l1 = 0;
  if (two) {
    const unsigned s1 = __match_any_sync(m, a1 >> 7);
    l1 = __ballot_sync(m, __ffs(s1) - 1 == lane);
  }
  if (lane == __ffs(m) - 1) {
    atomicAdd(c + 0, 1ull);
    atomicAdd(c + 1, static_cast<unsigned long long>(__popc(l0)));
    if (two) atomicAdd(c + 2, static_cast<unsigned long long>(__popc(l1)));
    atomicAdd(c + 3, static_cast<unsigned long long>(__popc(m)));
  }
}
#endif

#if PROBE_CLOCK
// The clock once `v` has arrived: the move waits on the load's scoreboard.
__device__ __forceinline__ long long clock_after(unsigned int v) {
  long long c;
  asm volatile("{\n\t.reg .b32 t;\n\tmov.b32 t, %1;\n\t"
               "mov.u64 %0, %%clock64;\n\t}"
               : "=l"(c)
               : "r"(v)
               : "memory");
  return c;
}
#endif

__device__ __forceinline__ void trace_one(
    const Params& P, int i, const float* __restrict__ clipped,
    const float* __restrict__ dirs, const float* __restrict__ entry_normal,
    const float* __restrict__ tminn, const unsigned char* __restrict__ ok,
    const int* __restrict__ iv, const int* __restrict__ bw,
    const int* __restrict__ pool, const int* __restrict__ pool_base,
    unsigned char* __restrict__ hit_out, float* __restrict__ t_out,
    float* __restrict__ normal_out, unsigned char* __restrict__ request_out,
    int* __restrict__ request_pos, unsigned char* __restrict__ exhausted_out,
    float* __restrict__ resume_out, int* __restrict__ iters_out,
    unsigned long long* __restrict__ counters) {
#if PROBE_ROW == 1
  __shared__ unsigned int srow[kThreads * kSlot];
  unsigned int* const slot = srow + threadIdx.x * kSlot;
#elif PROBE_PAD
  // The same shared memory as row mode 1 and no use of it: what the
  // smaller L1 alone costs.
  __shared__ unsigned int srow[kThreads * kSlot];
  if (P.max_iters < 0) srow[threadIdx.x * kSlot] = 0u;
#endif
#if PROBE_CLOCK
  const long long ck_start = clock64();
  long long ck_idx = 0, ck_row = 0, ck_sub = 0;
  long long n_idx = 0, n_row = 0, n_sub = 0;
#endif
  const float bszf = static_cast<float>(P.bsz);
  const bm::Axis ax = bm::make_axis(dirs[3 * i + 0]);
  const bm::Axis ay = bm::make_axis(dirs[3 * i + 1]);
  const bm::Axis az = bm::make_axis(dirs[3 * i + 2]);
  const float ox = clipped[3 * i + 0] / bszf;
  const float oy = clipped[3 * i + 1] / bszf;
  const float oz = clipped[3 * i + 2] / bszf;

  int px, py, pz;
  float tx, ty, tz;
  bm::axis_start(ox, ax, px, tx);
  bm::axis_start(oy, ay, py, ty);
  bm::axis_start(oz, az, pz, tz);
  bool active = ok[i] && px >= 0 && px < P.cx && py >= 0 && py < P.cy &&
                pz >= 0 && pz < P.cz;

  int budget = P.max_iters;
  int axis0 = -1;
  bool hit = false, request = false;
  float t = 0.0f, hnx = 0.0f, hny = 0.0f, hnz = 0.0f;
#if PROBE_TOP == 2
  int addr = xterm(px) + yterm(py, P.bw_y) + zterm(pz, P.bw_z);
#endif

  while (active) {
    if (budget == 0) break;
    --budget;
#if PROBE_TOP == 0
#if PROBE_CLOCK
    const long long ck0 = clock64();
#endif
    const unsigned int word =
        static_cast<unsigned int>(iv[(pz * P.cy + py) * P.cx + px]);
#if PROBE_CLOCK
    ck_idx += clock_after(word) - ck0;
    ++n_idx;
#endif
#elif PROBE_TOP == 1
    const unsigned int word = static_cast<unsigned int>(
        bw[xterm(px) + yterm(py, P.bw_y) + zterm(pz, P.bw_z)]);
#else
    const unsigned int word = static_cast<unsigned int>(bw[addr]);
#endif
#if PROBE_COUNT
    {
      const long long wi = (pz * P.cy + py) * P.cx + px;
      const long long wb = xterm(px) + yterm(py, P.bw_y) + zterm(pz, P.bw_z);
      count_lines(counters, reinterpret_cast<unsigned long long>(iv + wi),
                  reinterpret_cast<unsigned long long>(bw + wb), true);
      unsigned int* bits = reinterpret_cast<unsigned int*>(counters + 16);
      const long long fw = counters[12];
      mark(bits, wi >> 5);
      mark(bits + fw, wi >> 3);
      mark(bits + 2 * fw, wb >> 5);
      mark(bits + 3 * fw, wb >> 3);
    }
#endif
    const bool occ0 = (word & kFlagBits) != 0u;
    if (occ0) {
      float nd = 0.0f, ntx, nty, ntz;
      if (axis0 >= 0) {
        nd = bm::sel3(axis0, tx, ty, tz) -
             bm::sel3(axis0, ax.td, ay.td, az.td);
        const float sf = bm::sel3(axis0, bm::sign_f(ax.d), bm::sign_f(ay.d),
                                  bm::sign_f(az.d));
        ntx = axis0 == 0 ? -sf : 0.0f;
        nty = axis0 == 1 ? -sf : 0.0f;
        ntz = axis0 == 2 ? -sf : 0.0f;
      } else {
        ntx = entry_normal[3 * i + 0];
        nty = entry_normal[3 * i + 1];
        ntz = entry_normal[3 * i + 2];
      }
      const int ddx = P.cam_x - px, ddy = P.cam_y - py, ddz = P.cam_z - pz;
      const int d2 = ddx * ddx + ddy * ddy + ddz * ddz;
      const bool far = d2 > P.lod8;
      const bool mid = !far && d2 > P.lod2;
      if (far) {
        hit = true;
        t = nd * bszf;
        hnx = ntx; hny = nty; hnz = ntz;
        active = false;
        break;
      }
      int r = 0;
      float sub_t = 0.0f, scale = 1.0f;
      int sub_axis = -1;
      if (mid) {
        const unsigned int byte = (word >> 12) & 0xFFu;
        auto occ = [byte](int x, int y, int z) {
          const int lin = min(max(x + y * 2 + z * 4, 0), 7);
          return ((byte >> lin) & 1u) != 0u;
        };
        const float eps_byte = 0.2f * P.eps;
        scale = 4.0f;
        r = bm::sub_dda<2>((ox + ax.d * nd) * 2.0f - ntx * eps_byte,
                           (oy + ay.d * nd) * 2.0f - nty * eps_byte,
                           (oz + az.d * nd) * 2.0f - ntz * eps_byte, ax, ay,
                           az, occ, budget, sub_t, sub_axis);
      } else if (word & kLoadedBit) {
#if PROBE_CLOCK
        const long long ck_d = clock64();
        ++n_sub;
#endif
        const int sc = min(max(px / P.sc + (py / P.sc) * P.sc_xy +
                                   (pz / P.sc) * P.sc_xy * P.sc_xy, 0),
                           P.num_sc - 1);
        const int* row =
            pool + static_cast<long long>(pool_base[sc] +
                                          static_cast<int>(word & 0xFFFu)) * 16;
#if PROBE_COUNT
        count_lines(counters + 8, reinterpret_cast<unsigned long long>(row),
                    0ull, false);
#endif
#if PROBE_ROW == 0 && PROBE_CLOCK
        auto occ = [&](int x, int y, int z) {
          const int lin = min(max(x + y * 8 + z * 64, 0), 511);
          const long long c0 = clock64();
          const unsigned int v = static_cast<unsigned int>(row[lin >> 5]);
          ck_row += clock_after(v) - c0;
          ++n_row;
          return ((v >> (lin & 31)) & 1u) != 0u;
        };
#elif PROBE_ROW == 0
        auto occ = [row, counters](int x, int y, int z) {
          const int lin = min(max(x + y * 8 + z * 64, 0), 511);
#if PROBE_COUNT
          count_lines(counters + 4,
                      reinterpret_cast<unsigned long long>(row + (lin >> 5)),
                      0ull, false);
#endif
          return ((static_cast<unsigned int>(row[lin >> 5]) >> (lin & 31)) &
                  1u) != 0u;
        };
#elif PROBE_ROW == 1
        const int4* src = reinterpret_cast<const int4*>(row);
        const int4 q0 = __ldg(src + 0), q1 = __ldg(src + 1),
                   q2 = __ldg(src + 2), q3 = __ldg(src + 3);
        slot[0] = q0.x; slot[1] = q0.y; slot[2] = q0.z; slot[3] = q0.w;
        slot[4] = q1.x; slot[5] = q1.y; slot[6] = q1.z; slot[7] = q1.w;
        slot[8] = q2.x; slot[9] = q2.y; slot[10] = q2.z; slot[11] = q2.w;
        slot[12] = q3.x; slot[13] = q3.y; slot[14] = q3.z; slot[15] = q3.w;
        auto occ = [slot](int x, int y, int z) {
          const int lin = min(max(x + y * 8 + z * 64, 0), 511);
          return ((slot[lin >> 5] >> (lin & 31)) & 1u) != 0u;
        };
#else
        int cur = -1;
        unsigned int cw = 0u;
        auto occ = [&](int x, int y, int z) {
          const int lin = min(max(x + y * 8 + z * 64, 0), 511);
          if ((lin >> 5) != cur) {
            cur = lin >> 5;
            cw = static_cast<unsigned int>(row[cur]);
          }
          return ((cw >> (lin & 31)) & 1u) != 0u;
        };
#endif
        r = bm::sub_dda<8>((ox + ax.d * nd) * bszf - ntx * P.eps,
                           (oy + ay.d * nd) * bszf - nty * P.eps,
                           (oz + az.d * nd) * bszf - ntz * P.eps, ax, ay, az,
                           occ, budget, sub_t, sub_axis);
#if PROBE_CLOCK
        ck_sub += clock_after(static_cast<unsigned int>(r)) - ck_d;
#endif
      } else if (word & kUnloadedBit) {
        hit = request = true;
        t = nd * bszf;
        hnx = ntx; hny = nty; hnz = ntz;
        active = false;
        break;
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
        active = false;
        break;
      }
      if (r < 0) break;
    }
#if PROBE_TOP == 2
    const int opx = px, opy = py, opz = pz;
#endif
    if (!bm::top_step(word, occ0, ax, ay, az, P.cx, P.cy, P.cz, px, py, pz,
                      tx, ty, tz, axis0)) {
      active = false;
    }
#if PROBE_TOP == 2
    addr += (xterm(px) - xterm(opx)) +
            (yterm(py, P.bw_y) - yterm(opy, P.bw_y)) +
            (zterm(pz, P.bw_z) - zterm(opz, P.bw_z));
#endif
  }

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
  float resume = 0.0f;
  if (active) {
    const float rc = axis0 >= 0 ? bm::sel3(axis0, tx, ty, tz) -
                                      bm::sel3(axis0, ax.td, ay.td, az.td)
                                : 0.0f;
    resume = fmaxf(rc * bszf + tmin, 0.0f);
  }
  resume_out[i] = resume;
  iters_out[i] = P.max_iters - budget;
#if PROBE_CLOCK
  // Summed over the warp first (each thread's values fit 32 bits), so that
  // the counters' atomics do not crowd the memory pipe of the warps still
  // walking.
  const long long sums[7] = {clock64() - ck_start, ck_idx, ck_row, ck_sub,
                             n_idx, n_row, n_sub};
  const unsigned m = __activemask();
  for (int k = 0; k < 7; ++k) {
    const unsigned v =
        __reduce_add_sync(m, static_cast<unsigned>(sums[k]));
    if ((threadIdx.x & 31) == __ffs(m) - 1)
      atomicAdd(counters + k, static_cast<unsigned long long>(v));
  }
#endif
}

#define B2_ARGS                                                              \
  const float* __restrict__ clipped, const float* __restrict__ dirs,         \
      const float* __restrict__ entry_normal,                                \
      const float* __restrict__ tminn, const unsigned char* __restrict__ ok, \
      const int* __restrict__ iv, const int* __restrict__ bw,                \
      const int* __restrict__ pool, const int* __restrict__ pool_base,       \
      unsigned char* __restrict__ hit_out, float* __restrict__ t_out,        \
      float* __restrict__ normal_out,                                        \
      unsigned char* __restrict__ request_out,                               \
      int* __restrict__ request_pos,                                         \
      unsigned char* __restrict__ exhausted_out,                             \
      float* __restrict__ resume_out, int* __restrict__ iters_out,           \
      unsigned long long* __restrict__ counters
#define B2_PASS                                                            \
  clipped, dirs, entry_normal, tminn, ok, iv, bw, pool, pool_base, hit_out, \
      t_out, normal_out, request_out, request_pos, exhausted_out,          \
      resume_out, iters_out, counters

__global__ void __launch_bounds__(kThreads)
traverse_kernel(Params P, int n, B2_ARGS) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  trace_one(P, i, B2_PASS);
}

__global__ void __launch_bounds__(kThreads)
traverse_stride_kernel(Params P, int n, B2_ARGS) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    trace_one(P, i, B2_PASS);
}

}  // namespace

extern "C" int variant_launch(
    int n, const float* clipped, const float* dirs, const float* entry_normal,
    const float* tminn, const unsigned char* ok, const int* index_volume,
    const int* block_words, const int* pool_words, const int* pool_base,
    int cells_x, int cells_y, int cells_z, int sc_size, int sc_xy,
    int num_sc, int cam_x, int cam_y, int cam_z, int lod8, int lod2,
    int brick_size, float epsilon, int max_iters, unsigned char* hit,
    float* t, float* normal, unsigned char* request, int* request_pos,
    unsigned char* exhausted, float* resume_t, int* iters,
    unsigned long long* counters, int blocks_per_sm, void* stream) {
  const int nbx = (cells_x + 3) / 4, nby = (cells_y + 3) / 4;
  const Params P{cells_x, cells_y, cells_z, sc_size, sc_xy, num_sc,
                 cam_x,   cam_y,   cam_z,   lod8,    lod2,  brick_size,
                 epsilon, max_iters, nbx * 64, nbx * nby * 64};
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kThreads - 1) / kThreads;
  if (blocks_per_sm > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int grid = min(blocks, blocks_per_sm * sms);
    traverse_stride_kernel<<<grid, kThreads, 0, st>>>(
        P, n, clipped, dirs, entry_normal, tminn, ok, index_volume,
        block_words, pool_words, pool_base, hit, t, normal, request,
        request_pos, exhausted, resume_t, iters, counters);
  } else {
    traverse_kernel<<<blocks, kThreads, 0, st>>>(
        P, n, clipped, dirs, entry_normal, tminn, ok, index_volume,
        block_words, pool_words, pool_base, hit, t, normal, request,
        request_pos, exhausted, resume_t, iters, counters);
  }
  return static_cast<int>(cudaGetLastError());
}
