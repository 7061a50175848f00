// Kernels W0-W4: the sample wave's stages around the traversal (B2), one
// CUDA thread per lane, ray or row.
//
// They have no Pallas twin: the JAX package leaves these stages to XLA,
// which fuses each jitted stage into a few device programs.
//   W0 compact_kernel      the pack index of _compact_trace (:59), a cumsum
//                          over the live mask: the set rows' indices in
//                          ascending order (torch.nonzero's) and their
//                          count, both left on the device.
//   W1 primary_kernel      brickmap_tpu/render/pathtrace.py::_primary_state
//                          (:293) with render/camera.py::
//                          primary_rays_from_arrays (:81): stratified jitter,
//                          thin-lens disk, the camera basis.
//   W2 gather_clip_kernel  the live-lane gather of _compact_trace (:59) fused
//                          with ops/traverse.py::aabb_clip (:73): exactly the
//                          five inputs B2's launcher reads, plus each lane's
//                          position in the compacted list.
//   W3 shade_kernel        _shade_update (:519), or with `final`
//                          _final_accum_update (:609): NEE accumulation,
//                          miss radiance (sunsky at bounce 0, sky after), the
//                          hit point, the sun-cone, sun and cosine-hemisphere
//                          samples, the next extension and shadow rays, the
//                          request merge and the ray counters.
//   W4 rescue_kernel       _cond_rescue (:385) with _rescue_pass (:342): the
//                          exhausted rays re-traced with the escalated budget,
//                          every pass of a ray in one thread (W2's clip, then
//                          B2's walk, traverse_walk.inc).
//   W5 blit_kernel         render/pathtrace.py::tonemap (:52) with
//                          utils/image.py::to_uint8 (:14): the film as 8
//                          bits a channel (the reference's
//                          blit_onto_framebuffer, kernel.cu:357-362), one
//                          thread a pixel, 16 B read and 3 B written.
// The plain versions are brickmap_tpu_torch/ops/wave.py; each kernel
// rounds every operation as that torch code does on the same device.
//
// No host round trip.  The JAX wave picks its compaction bucket with
// lax.switch and gates its rescue with lax.cond, both on device counts.
// Here W0 writes the count on the device and W2, B2 and W4 read it there.
// W0, W2 and W4 launch at most the blocks resident at once, so a small
// count costs one wave of blocks, not a grid over the capacity (the wave's
// 2N rays, or a trace's compacted ones): W2's blocks walk its 256-row
// tiles with a grid-stride loop; W0's and W4's take their work from a
// cursor in a scratch buffer the wrapper keeps (zeroed again by each
// launch, so a launch carries no host state and a graph of the wave could
// replay it).
// A trace is W0 -> W2 -> B2 -> W0 (exhausted) -> W4 with nothing copied to
// the host; when nothing is exhausted, W4's blocks all return.  W0 is one
// pass with a decoupled look-back: 4096-row tiles taken in order, each
// tile's offset from the counts its predecessors published, its set rows
// staged in shared memory and stored as one run.  A ray is independent of
// the others in a rescue pass, so W4 runs a ray's passes back to back in
// one thread, in the passes' float operations and order: its results equal
// the host loop's bit for bit; its warps take 32 rays at a time.
//
// What bounds them on an H100: bytes.  W3 does ~400 float operations a lane
// (three sky evaluations' exp/acos/pow, two cosines and sines, square
// roots) and moves ~230 bytes, so at 67 TFLOP/s and 3.35 TB/s its bytes
// take ~10x longer; W1 and W2 move 120 and 77 bytes a lane with less
// arithmetic, W0 a byte a row and 4 a set row (its launch, its look-back
// chain and its empty tail bound it at the wave's sizes).  W4 is B2's
// walk, bound as B2 is.  The design therefore keeps every lane's state in
// device memory exactly once a stage: W1 writes the wave's [2N] ray buffers and
// state in place; W2 writes B2's inputs directly (no separate gather, clip
// or copy to contiguous); W3 reads B2's compacted results through W2's
// position map (no scatter into full-size tensors) and writes the next
// bounce's rays into the same [2N] buffers (no concatenation), and on the
// last pass writes the wave's outputs through the tile permutation.  A
// lane's loads and stores are 4-byte words at neighbouring addresses across
// a warp (W2 stages its [*, 3] outputs and stores them as runs of 16-byte
// words); the ray counters are summed in the block and added with one
// 64-bit atomic a block.
//
// Rounding.  Built with -fmad=false and no fast math, every operation
// rounds once as torch's op does.  Where torch's CUDA and CPU kernels
// differ, the CUDA form is under __CUDA_ARCH__ and the CPU form is the
// host build's (csrc/host_shim.h, tests/test_torch_wave_host.py): a
// 3-wide `.sum(-1)` adds (a + c) + b on the card and (a + b) + c on the CPU;
// `tensor / python_float` multiplies by the float reciprocal on the card and
// divides on the CPU.  `scalar / tensor` is `reciprocal(tensor) * scalar` on
// both; `torch.linalg.cross` is fma(a1, b2, -(a2 * b1)) on both;
// `x ** 1.5` and `** 5` are powf, `x ** 2` is x * x; torch's sin, cos, exp,
// acos and sqrt are libdevice's, as here (notes/probe_torch_wave_rounding.py
// measured each on the card).  cone_sample forms 1 - u2 * extent and
// 1 - ry^2 in double and rounds once, as its plain version does.
//
// Built by brickmap_tpu_torch/kernels/build.py (nvcc, sm_90a, -fmad=false);
// bound with ctypes by brickmap_tpu_torch/kernels/wave.py.

#include <cuda_runtime.h>

#include <math.h>

#include "traverse.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kFocalScale = 3.0f;  // the reference's ImGui_slider_hack
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kQuarterPi = 0.78539816339744830962f;
constexpr float kHalfPi = 1.57079632679489661923f;

// Layout of the sky constants (kernels/wave.py::sky_constants).
enum Sky {
  kRayleigh = 0,   // 3: the Rayleigh coefficients
  kMie = 3,        // 3: _total_mie * mie_coefficient
  kIntensity = 6,  // sun_intensity
  kCutoff,         // cutoff_angle
  kSteepness,      // steepness
  kRayleighLen,    // rayleigh_zenith_length
  kMieLen,         // mie_zenith_length
  kRayleighPhase,  // 3 / (16 pi)
  kHgPhase,        // 1 / (4 pi)
  kOneMinusG2,     // 1 - g^2
  kTwoG,           // 2 g
  kG2,             // g^2
  kSkyScale,       // sky_factor * 0.01
  kSadc,           // sun_angular_diameter_cos
  kSmoothWidth,    // (sadc + 0.00002) - sadc
  kDiscNonzero,    // float(sadc < 1)
  kDiscZero,       // float(sadc < 0)
  kConeExtent,     // 1 - sadc, as float32
  kSkyCount
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float sum3(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return (a + c) + b;  // torch's CUDA reduction over a 3-wide row
#else
  return (a + b) + c;  // torch's CPU reduction
#endif
}

// `tensor / python_float` (the scalar taken as a float).
__device__ __forceinline__ float div_s(float x, float s) {
#ifdef __CUDA_ARCH__
  return x * (1.0f / s);
#else
  return x / s;
#endif
}

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

__device__ __forceinline__ V3 load3(const float* p, long long i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__device__ __forceinline__ V3 fill3(float v) { return {v, v, v}; }

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return sum3(a.x * b.x, a.y * b.y, a.z * b.z);
}

__device__ __forceinline__ V3 normalize3(V3 v) {
  const float len = sqrtf(dot3(v, v));
  return {v.x / len, v.y / len, v.z / len};
}

// libdevice's sinf/cosf of an argument below 100 in magnitude: every angle
// here is (2 pi) times a uniform in [0, 1] or a thin-lens disk angle in
// [-pi/4, 3 pi/4] (injected uniforms are checked to lie in [0, 1],
// render/pathtrace.py's _check_uniforms).  The guard lets nvcc drop the
// functions' reduction path for |x| > 105615, whose local array is a
// 32-byte stack frame; outside it the result is NaN.
__device__ __forceinline__ float sin_small(float x) {
  return fabsf(x) < 100.0f ? sinf(x) : NAN;
}

__device__ __forceinline__ float cos_small(float x) {
  return fabsf(x) < 100.0f ? cosf(x) : NAN;
}

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {__fmaf_rn(a.y, b.z, -(a.z * b.y)), __fmaf_rn(a.z, b.x, -(a.x * b.z)),
          __fmaf_rn(a.x, b.y, -(a.y * b.x))};
}

// ---- ops/sunsky.py ------------------------------------------------------

struct SkyCommon {
  float sun_e, cos_vs;
  float fex[3], sky[3];
};

// _common(view, sun): the scattering core.
__device__ SkyCommon sky_common(V3 view, V3 sun, const float* K) {
  SkyCommon r;
  r.cos_vs = dot3(view, sun);
  const float cos_sun_up = sun.z;
  const float cvs = r.cos_vs;
  r.sun_e = clamp_min0(1.0f - expf(-div_s(K[kCutoff] - acosf(cos_sun_up),
                                          K[kSteepness]))) *
            K[kIntensity];
  const float zenith = clamp_min0(view.z);
  const float rzen = 1.0f / zenith;  // 1/0 -> inf -> exp(-inf) = 0
  const float rlen = rzen * K[kRayleighLen];
  const float mlen = rzen * K[kMieLen];
  const float rphase = (cvs * cvs + 1.0f) * K[kRayleighPhase];
  const float den = (1.0f - cvs * K[kTwoG]) + K[kG2];
  const float hg = ((1.0f / powf(den, 1.5f)) * K[kOneMinusG2]) * K[kHgPhase];
  const float mix = clamp01(powf(1.0f - cos_sun_up, 5.0f));
  for (int k = 0; k < 3; ++k) {
    const float ray = K[kRayleigh + k], mie = K[kMie + k];
    const float fex = expf(-(ray * rlen + mie * mlen));
    const float some = r.sun_e * ((ray * rphase + mie * hg) / (ray + mie));
    const float term = some * (1.0f - fex);
    r.fex[k] = fex;
    r.sky[k] = term * ((1.0f - mix) + sqrtf(some * fex) * mix);
  }
  return r;
}

// sun(view, sun): radiance along a sampled cone direction.
__device__ V3 sun_radiance(V3 view, V3 sun, const float* K) {
  const SkyCommon c = sky_common(view, sun, K);
  const float disc = c.cos_vs != 0.0f ? K[kDiscNonzero] : K[kDiscZero];
  const float base = c.sun_e * 19000.0f;
  float v[3];
  for (int k = 0; k < 3; ++k) v[k] = ((base * c.fex[k]) * 0.01f) * disc;
  return {v[0], v[1], v[2]};
}

// sky(view, sun) for bounce-miss rays, sunsky(view, sun) for primary misses.
__device__ V3 miss_radiance(V3 view, V3 sun, bool primary, const float* K) {
  const SkyCommon c = sky_common(view, sun, K);
  float v[3];
  if (!primary) {
    for (int k = 0; k < 3; ++k) v[k] = c.sky[k] * K[kSkyScale];
  } else {
    const float t =
        clamp01(div_s(c.cos_vs - K[kSadc], K[kSmoothWidth]));
    const float disc = (t * t) * (3.0f - t * 2.0f);
    const float base = c.sun_e * 19000.0f;
    for (int k = 0; k < 3; ++k)
      v[k] = ((((base * c.fex[k]) * disc) * 1e-5f) + c.sky[k]) * 0.01f;
  }
  return {v[0], v[1], v[2]};
}

// ---- render/sampling.py -------------------------------------------------

// cone_sample(u1, u2, sun, extent): a direction in the solar cone.
__device__ V3 cone_sample(float u1, float u2, V3 sun, double extent) {
  const V3 d = normalize3(sun);
  const bool use_x = fabsf(d.x) > fabsf(d.z);
  const V3 o1 = normalize3(use_x ? V3{-d.y, d.x, 0.0f}
                                 : V3{0.0f, -d.z, d.y});
  const V3 o2 = normalize3(cross3(d, o1));
  const float rx = (u1 * 2.0f) * kPi;
  const float ry = static_cast<float>(1.0 - static_cast<double>(u2) * extent);
  const double rd = static_cast<double>(ry);
  const float om = sqrtf(static_cast<float>(1.0 - rd * rd));
  const float c = cos_small(rx) * om, s = sin_small(rx) * om;
  return {(c * o1.x + s * o2.x) + ry * d.x, (c * o1.y + s * o2.y) + ry * d.y,
          (c * o1.z + s * o2.z) + ry * d.z};
}

// cosine_hemisphere(u1, u2, n): a cosine-weighted bounce direction.
__device__ V3 cosine_hemisphere(float u1, float u2, V3 n) {
  const float r1 = u1 * kTwoPi;
  const float r2s = sqrtf(u2);
  const V3 pick = fabsf(n.x) > 0.9f ? V3{0.0f, 1.0f, 0.0f}
                                    : V3{1.0f, 0.0f, 0.0f};
  const V3 u = normalize3(cross3(pick, n));
  const V3 v = cross3(n, u);
  const float c = cos_small(r1) * r2s, s = sin_small(r1) * r2s;
  const float w = sqrtf(1.0f - u2);
  return normalize3({(u.x * c + v.x * s) + n.x * w,
                     (u.y * c + v.y * s) + n.y * w,
                     (u.z * c + v.z * s) + n.z * w});
}

// ---- W1 -----------------------------------------------------------------

struct Camera {
  const float *pos, *dir, *right, *up, *focal, *lens_radius;
};

__global__ void __launch_bounds__(kThreads)
primary_kernel(int n, const long long* __restrict__ idx,
               const long long* __restrict__ stratum,
               const float* __restrict__ jitter,
               const float* __restrict__ lens, Camera cam, int width,
               int height, float* __restrict__ rays_o,
               float* __restrict__ rays_d, unsigned char* __restrict__ live,
               int* __restrict__ pos, float* __restrict__ accum,
               float* __restrict__ sh_color,
               unsigned char* __restrict__ req_mask,
               int* __restrict__ req_pos,
               unsigned long long* __restrict__ counters) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i == 0) counters[0] = counters[1] = 0ull;
  if (i >= n) return;
  const long long p = idx[i];
  const float x = static_cast<float>(p % width);
  const float y = static_cast<float>(p / width);
  const long long s = stratum[i];
  // stratified_2d: a 4x4 stratum plus the in-stratum jitter.
  const float j0 = div_s(static_cast<float>(s % 4) + jitter[2 * i], 4.0f);
  const float j1 =
      div_s(static_cast<float>((s / 4) % 4) + jitter[2 * i + 1], 4.0f);
  const float px = x - j0, py = y - j1;
  const float ni = div_s(px, static_cast<float>(width)) - 0.5f;
  const float nj = div_s(static_cast<float>(height) - py,
                         static_cast<float>(height)) - 0.5f;

  const V3 cpos{cam.pos[0], cam.pos[1], cam.pos[2]};
  const V3 cdir{cam.dir[0], cam.dir[1], cam.dir[2]};
  const V3 right{cam.right[0], cam.right[1], cam.right[2]};
  const V3 up{cam.up[0], cam.up[1], cam.up[2]};
  const V3 tf = normalize3({(cdir.x + ni * right.x) + nj * up.x,
                            (cdir.y + ni * right.y) + nj * up.y,
                            (cdir.z + ni * right.z) + nj * up.z});
  const float fs = cam.focal[0] * kFocalScale;
  const V3 conv{cpos.x + fs * tf.x, cpos.y + fs * tf.y, cpos.z + fs * tf.z};

  // concentric_disk(lens): the thin-lens sample.
  const float ox = lens[2 * i] * 2.0f - 1.0f;
  const float oy = lens[2 * i + 1] * 2.0f - 1.0f;
  const bool use_x = fabsf(ox) > fabsf(oy);
  const float r = use_x ? ox : oy;
  const float theta =
      use_x ? (oy / (ox == 0.0f ? 1.0f : ox)) * kQuarterPi
            : kHalfPi - (ox / (oy == 0.0f ? 1.0f : oy)) * kQuarterPi;
  const bool zero = ox == 0.0f && oy == 0.0f;
  const float d0 = zero ? 0.0f : r * cos_small(theta);
  const float d1 = zero ? 0.0f : r * sin_small(theta);
  const float lr = cam.lens_radius[0];
  const float pl0 = lr * d0, pl1 = lr * d1;
  const V3 o{(cpos.x + right.x * pl0) + up.x * pl1,
             (cpos.y + right.y * pl0) + up.y * pl1,
             (cpos.z + right.z * pl0) + up.z * pl1};
  const V3 d = normalize3({conv.x - o.x, conv.y - o.y, conv.z - o.z});

  store3(rays_o, i, o);
  store3(rays_d, i, d);
  store3(rays_o, n + i, fill3(-10.0f));  // bounce 0 has no shadow ray
  store3(rays_d, n + i, fill3(-1.0f));
  live[i] = 1;
  live[n + i] = 0;
  pos[i] = pos[n + i] = -1;
  store3(accum, i, fill3(0.0f));
  store3(sh_color, i, fill3(0.0f));
  req_mask[i] = 0;
  req_pos[3 * i] = req_pos[3 * i + 1] = req_pos[3 * i + 2] = 0;
}

// ---- W0 -----------------------------------------------------------------

// A tile of kScanTile rows, kScanItems consecutive rows a thread.
constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kScanWarps = kScanThreads / 32;
constexpr unsigned int kFullWarp = 0xffffffffu;

// The scratch a wrapper holds for each device and stream
// (kernels/wave.py::scratch): four int counters (two 64-bit words), then
// W0's status word a tile.  Every launch leaves it zeroed: the last block
// out resets what the launch used.
enum Ctl { kW0Cursor = 0, kW0Exits, kW4Cursor, kW4Exits };
constexpr int kCtlWords = 2;
// A tile's status: a flag in bits 32-33 over a count in bits 0-31, the
// tile's own (kAggregate) or with every tile before it (kInclusive); 0
// while the tile is unpublished.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;
// Polls of an unpublished status the host build allows: its blocks run in
// order, so each earlier tile is published before a later block reads it.
constexpr int kHostSpins = 1 << 20;

// A status read with acquire and published with release order at the
// device's scope (L2: never a stale L1 line).  In the host build a
// volatile access: a block's threads meet at barriers, and its blocks run
// one after another.
__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
#ifdef __CUDA_ARCH__
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
#else
  return *static_cast<const volatile unsigned long long*>(p);
#endif
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long flag,
                                             int n) {
  const unsigned long long v = flag | static_cast<unsigned int>(n);
#ifdef __CUDA_ARCH__
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
#else
  *static_cast<volatile unsigned long long*>(p) = v;
#endif
}

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

// The set rows of tiles [0, tile): a look-back by the calling warp over the
// statuses of the tiles before `tile`, 32 at a time, nearest first, adding
// aggregates until one status is inclusive.  Every lane must call it, and
// every lane gets the sum.  A status still 0 belongs to a tile that a
// running block took from the cursor before this one: it publishes its
// aggregate without waiting on anything.
__device__ __forceinline__ int look_back(const unsigned long long* status,
                                         int tile) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  int before = 0;
  for (int end = tile - 1;; end -= 32) {
    const int p = end - lane;
    unsigned long long s = kInclusive;  // before tile 0: an inclusive 0
    if (p >= 0) {
      for (int spins = 0; ((s = load_status(status + p)) >> 32) == 0;
           ++spins) {
#ifndef __CUDA_ARCH__
        if (spins > kHostSpins) __trap();
#endif
      }
    }
    const unsigned int inclusive =
        __ballot_sync(kFullWarp, (s & kInclusive) != 0);
    const int stop = inclusive != 0u ? __ffs(inclusive) - 1 : 31;
    before += __reduce_add_sync(
        kFullWarp, lane <= stop ? static_cast<int>(s & 0xFFFFFFFFull) : 0);
    if (inclusive != 0u) return before;
  }
}

// One launch a compaction, a single pass with a decoupled look-back
// (Merrill and Garland, 2016).  A grid of the blocks resident at once takes
// tiles in order from the scratch's cursor until they run out.  A tile:
// its mask read once (16 bytes a thread), each thread's rank from a warp
// shuffle scan of the threads' counts and the warps' sums, the tile's
// count published as an aggregate, then warp 0's look-back gives the count
// before it and publishes the inclusive count, while the other warps stage
// the tile's set rows in shared memory at their ranks; then the block
// stores them as one contiguous run at the offset.  The block with the last
// tile writes the count; the last block out zeroes the statuses and
// counters the launch used.  A tile waits only on tiles taken before it,
// by blocks that are running, so the grid cannot deadlock.
__global__ void __launch_bounds__(kScanThreads)
compact_kernel(int cap, const unsigned char* __restrict__ mask,
               const int* __restrict__ limit, int* __restrict__ out,
               int* __restrict__ count,
               unsigned long long* __restrict__ scratch) {
  __shared__ int stage[kScanTile];
  __shared__ int warp_sums[kScanWarps];
  __shared__ int next_tile, offset, last_out;
  int* const ctl = reinterpret_cast<int*>(scratch);
  unsigned long long* const status = scratch + kCtlWords;
  const int rows = mask_rows(cap, limit);
  const int tiles = (rows + kScanTile - 1) / kScanTile;
  if (tiles == 0) {  // every block returns: nothing was taken
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
    int rank = own;  // the warp's inclusive scan of its threads' counts
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
    }
    if (tile == tiles - 1 && threadIdx.x == 0) *count = before + total;
    __syncthreads();
  }
  // Every block counts itself out after its last look-back; the last one
  // out resets the statuses and the counters for the next launch.
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

// A tile of W2: kGatherTile consecutive rows of the compacted list, a row
// a thread.  Its [kGatherTile, 3] float outputs are whole 16-byte words
// (3,072 bytes), so a tile that starts on a 16-byte boundary ends on one.
constexpr int kGatherTile = 256;
constexpr int kGatherWords = 3 * kGatherTile;
// Rows [base, base + rows) of a [*, 3] float output from a tile staged in
// shared memory: the whole 16-byte words as one contiguous run, then the
// last 0-2 floats of a partial tile one by one.  No word at or past row
// base + rows is written.  `out` is 16-byte aligned (the launcher checks).
__device__ __forceinline__ void store_tile3(float* __restrict__ out,
                                            const float4* stage, int base,
                                            int rows) {
  float* const dst = out + 3 * static_cast<long long>(base);
  const int words = 3 * rows, quads = words / 4;
  for (int q = static_cast<int>(threadIdx.x); q < quads; q += kGatherTile) {
    reinterpret_cast<float4*>(dst)[q] = stage[q];
  }
  const int w = 4 * quads + static_cast<int>(threadIdx.x);
  if (w < words) dst[w] = reinterpret_cast<const float*>(stage)[w];
}

// The rays at rows lanes[k], k < *count (W0's compaction), clipped to the
// world box.  A grid of at most the blocks resident at once walks the
// count's tiles with a grid-stride loop (every row costs the same: no
// balance to keep); with a count of 0 every block returns at once.  A
// tile: each thread gathers its ray at lanes[k], clips it, stores tmin
// and ok (a warp's run of 128 and 32 bytes: whole sectors) and stages its
// clipped origin, direction and entry normal in shared memory; then the
// block stores each of the three as one run of 16-byte words.  Loading a
// tile whose lanes are one run of rows (bounce 0's) as 16-byte words
// through shared memory was 4-16% slower at bounces 0 and 1 on an H100
// (notes/probe_torch_w2_variants.cu).  No minimum of blocks an SM in the
// launch bounds: ptxas gives it 40 registers, 6 blocks an SM (the grid's
// 792 on an H100); a minimum of 8 caps it at 32 registers with spills,
// and was 10% slower.
__global__ void __launch_bounds__(kGatherTile)
gather_clip_kernel(const int* __restrict__ count,
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

// ---- W4 -----------------------------------------------------------------

constexpr int kRescueThreads = 128;
// Blocks of W4 an SM: 7 (28 warps), one fewer than its 63 registers
// allow.  On view 0's 1,764,177 starved primaries 8 blocks an SM took
// 0.594-0.625 ms, 7 0.551-0.572 and 6 0.565 (notes/probe_torch_w0w4.py,
// H100 80GB HBM3).
constexpr int kRescueBlocksPerSm = 7;

// B2's results over a trace's compacted rays, rewritten by the rescue.
struct Rescued {
  unsigned char *hit, *request, *exhausted;
  float *t, *normal, *resume;
  int* request_pos;
};

// The exhausted ray at row `at` of B2's results (lane lanes[at] of the
// wave's buffers) re-traced up to `passes` times with the escalated budget
// (P.max_iters), each pass from 2 voxels before the entry of the cell the
// last one stopped in (the prefix is known empty): the passes of the host
// loop (ops/wave.py::rescue_plain) for one ray, W2's clip and B2's walk
// (traverse_walk.inc) in their operation order.
__device__ __forceinline__ void rescue_ray(
    int at, const int* __restrict__ lanes, const float* __restrict__ rays_o,
    const float* __restrict__ rays_d, Box box, bm::TraverseParams P,
    int passes, const int* __restrict__ iv, const int* __restrict__ pool,
    const int* __restrict__ pool_base, Rescued res) {
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

// The exhausted rays rows[j], j < *count (W0 over B2's `exhausted`), each
// rescued by one thread.  A grid of at most kRescueBlocksPerSm blocks an
// SM, which stay resident; each warp takes the next 32 rows from the
// scratch's cursor until they run out, so a warp whose rays end early
// starts new ones while the long rays run on.  The count is read again at
// each fetch: held in a register across the rays, it lengthened the
// walk's inner loops by 3 instructions (49 -> 52 in the SASS) and cost
// ~6% (notes/probe_torch_w0w4.py).  With a count of 0 every block returns
// at once and the cursor is left alone; otherwise the last block out
// resets it.
__global__ void __launch_bounds__(kRescueThreads, 8)
rescue_kernel(const int* __restrict__ count, const int* __restrict__ rows,
              const int* __restrict__ lanes,
              const float* __restrict__ rays_o,
              const float* __restrict__ rays_d, Box box,
              bm::TraverseParams P, int passes,
              const int* __restrict__ iv, const int* __restrict__ pool,
              const int* __restrict__ pool_base, Rescued res,
              int* __restrict__ ctl) {
  if (passes <= 0 || *count <= 0) return;
  for (;;) {
    const int lane = static_cast<int>(threadIdx.x) % 32;
    int first = 0;
    if (lane == 0) first = atomicAdd(ctl + kW4Cursor, 32);
    first = __shfl_sync(kFullWarp, first, 0);
    const int n = *count;
    if (first >= n) break;
    if (first + lane < n) {
      rescue_ray(rows[first + lane], lanes, rays_o, rays_d, box, P, passes,
                 iv, pool, pool_base, res);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(ctl + kW4Exits, 1) == static_cast<int>(gridDim.x) - 1) {
      ctl[kW4Cursor] = ctl[kW4Exits] = 0;
    }
  }
}

// ---- W3 -----------------------------------------------------------------

// B2's results over the compacted rays.
struct Traced {
  const unsigned char *hit, *request, *exhausted;
  const float *t, *normal;
  const int* request_pos;
};

struct Result {
  bool hit, request, exhausted;
  float t;
  V3 normal;
  int rp[3];
};

// A lane's result, or the dead-lane defaults (all zero).
__device__ __forceinline__ Result result_of(const Traced& r, bool live,
                                            int k) {
  Result v{};
  if (live && k >= 0) {
    v.hit = r.hit[k] != 0;
    v.request = r.request[k] != 0;
    v.exhausted = r.exhausted[k] != 0;
    v.t = r.t[k];
    v.normal = load3(r.normal, k);
    for (int a = 0; a < 3; ++a) v.rp[a] = r.request_pos[3 * k + a];
  }
  return v;
}

struct Samples {
  const float *cone1, *cone2, *hemi1, *hemi2;
};

struct Outputs {
  const long long* dst;  // output row of each lane (null: the lane's own)
  float *rgb, *count;
  unsigned char* mask;
  int* pos;
};

__device__ __forceinline__ void add_counts(unsigned long long* counters,
                                           unsigned int traced,
                                           unsigned int exhausted) {
#ifdef __CUDA_ARCH__
  __shared__ unsigned int part[2][kThreads / 32];
  traced = __reduce_add_sync(0xffffffffu, traced);
  exhausted = __reduce_add_sync(0xffffffffu, exhausted);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    part[0][warp] = traced;
    part[1][warp] = exhausted;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long a = 0, b = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      a += part[0][w];
      b += part[1][w];
    }
    if (a) atomicAdd(&counters[0], a);
    if (b) atomicAdd(&counters[1], b);
  }
#else
  if (traced) atomicAdd(&counters[0], traced);
  if (exhausted) atomicAdd(&counters[1], exhausted);
#endif
}

__global__ void __launch_bounds__(kThreads)
shade_kernel(int n, int bounce, int max_bounces, int final_pass,
             float* __restrict__ rays_o, float* __restrict__ rays_d,
             unsigned char* __restrict__ live, int* __restrict__ pos,
             Traced res, float* __restrict__ sh_color,
             float* __restrict__ accum, unsigned char* __restrict__ req_mask,
             int* __restrict__ req_pos,
             unsigned long long* __restrict__ counters, Samples u,
             const float* __restrict__ sun_dir, const float* __restrict__ K,
             float eps2, Outputs out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  unsigned int n_traced = 0, n_exhausted = 0;
  if (i < n) {
    const bool act = live[i] != 0, sact = live[n + i] != 0;
    const Result re = result_of(res, act, act ? pos[i] : -1);
    const Result rs = result_of(res, sact, sact ? pos[n + i] : -1);
    pos[i] = pos[n + i] = -1;  // dead until the next gather
    n_traced = act + sact;
    const bool ext_exh = re.exhausted && act, sh_exh = rs.exhausted && sact;
    n_exhausted = ext_exh + sh_exh;

    // Requests: a shadow ray's overwrites the extension ray's.
    const bool req_ext = re.request && act, req_sh = rs.request && sact;
    const unsigned char mask = req_mask[i] | req_ext | req_sh;
    int rp[3];
    for (int a = 0; a < 3; ++a) {
      rp[a] = req_pos[3 * i + a];
      rp[a] = req_ext ? re.rp[a] : rp[a];
      rp[a] = req_sh ? rs.rp[a] : rp[a];
    }
    // NEE: an unoccluded shadow ray adds its sun colour.
    const bool sun_seen = sact && !rs.hit && !sh_exh;
    const V3 shc = load3(sh_color, i);
    V3 acc = load3(accum, i);
    acc = {acc.x + (sun_seen ? shc.x : 0.0f), acc.y + (sun_seen ? shc.y : 0.0f),
           acc.z + (sun_seen ? shc.z : 0.0f)};
    const V3 o = load3(rays_o, i), d = load3(rays_d, i);
    const V3 sun{sun_dir[0], sun_dir[1], sun_dir[2]};

    if (final_pass) {
      const long long j = out.dst != nullptr ? out.dst[i] : i;
      store3(out.rgb, j, acc);
      out.count[j] = 1.0f;
      out.mask[j] = mask;
      for (int a = 0; a < 3; ++a) out.pos[3 * j + a] = rp[a];
    } else {
      req_mask[i] = mask;
      for (int a = 0; a < 3; ++a) req_pos[3 * i + a] = rp[a];
      // Misses see the sky (budget-truncated lanes are not misses).
      if (act && !re.hit && !ext_exh) {
        const V3 rad = miss_radiance(d, sun, bounce == 0, K);
        acc = {acc.x + rad.x, acc.y + rad.y, acc.z + rad.z};
      }
      store3(accum, i, acc);

      const bool hit = act && re.hit;
      const V3 nn = dot3(re.normal, re.normal) > 0.0f
                        ? re.normal
                        : V3{-d.x, -d.y, -d.z};
      const V3 hp{(o.x + d.x * re.t) + nn.x * eps2,
                  (o.y + d.y * re.t) + nn.y * eps2,
                  (o.z + d.z * re.t) + nn.z * eps2};
      const V3 sdir = cone_sample(u.cone1[i], u.cone2[i], sun,
                                  static_cast<double>(K[kConeExtent]));
      const float sun_cos = dot3(nn, sdir);
      const V3 srad = sun_radiance(sdir, sun, K);
      const V3 nd = cosine_hemisphere(u.hemi1[i], u.hemi2[i], nn);
      const bool new_active = hit && bounce < max_bounces;
      const bool new_sh = hit && sun_cos > 0.0f;
      const float sc = sun_cos * 1e-5f;
      store3(sh_color, i, {srad.x * sc, srad.y * sc, srad.z * sc});
      store3(rays_o, i, new_active ? hp : fill3(-10.0f));
      store3(rays_d, i, new_active ? nd : fill3(-1.0f));
      store3(rays_o, n + i, new_sh ? hp : fill3(-10.0f));
      store3(rays_d, n + i, new_sh ? sdir : fill3(-1.0f));
      live[i] = new_active;
      live[n + i] = new_sh;
    }
  }
  add_counts(counters, n_traced, n_exhausted);
}

// torch's clamp of a float tensor to a scalar bound: NaN stays NaN.
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// W5: count-normalise, clamp at 0, pow 1/2.2, clamp to [0, 1], x 255 + 0.5
// and truncate, each step one rounding as torch's op (the scalars as torch
// takes a Python float for a float32 tensor; `** (1 / 2.2)` is powf).
__global__ void __launch_bounds__(kThreads)
    blit_kernel(int n, const float* __restrict__ rgb,
                const float* __restrict__ count,
                unsigned char* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float c = clamp_lo(count[i], static_cast<float>(1e-8));
  for (int k = 0; k < 3; ++k) {
    float v = clamp_lo(rgb[3 * i + k] / c, 0.0f);
    v = powf(v, static_cast<float>(1.0 / 2.2));
    v = isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
    out[3 * i + k] = static_cast<unsigned char>(v * 255.0f + 0.5f);
  }
}

// Blocks of `kernel` (`threads` threads each) resident at once on the
// current device: its SMs times the occupancy calculator's blocks an SM (at
// most `per_sm_cap`), kept per device in `cache`.
template <class K>
int resident_blocks(K kernel, int threads, int (&cache)[64],
                    int per_sm_cap = 1 << 30) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  int& slot = cache[dev & 63];
  if (slot == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  0);
    slot = max(sms * min(per_sm, per_sm_cap), 1);
  }
  return slot;
}

}  // namespace

extern "C" int wave_primary_launch(
    int n, const long long* idx, const long long* stratum,
    const float* jitter, const float* lens, const float* cam_pos,
    const float* cam_dir, const float* cam_right, const float* cam_up,
    const float* focal, const float* lens_radius, int width, int height,
    float* rays_o, float* rays_d, unsigned char* live,
    int* pos, float* accum, float* sh_color, unsigned char* req_mask,
    int* req_pos, unsigned long long* counters, void* stream) {
  const Camera cam{cam_pos, cam_dir, cam_right, cam_up, focal, lens_radius};
  const int blocks = n > 0 ? (n + kThreads - 1) / kThreads : 1;
  primary_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, idx, stratum, jitter, lens, cam, width, height, rays_o, rays_d,
      live, pos, accum, sh_color, req_mask, req_pos, counters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wave_compact_launch(int cap, const unsigned char* mask,
                                   const int* limit, int* out, int* count,
                                   unsigned long long* scratch,
                                   void* stream) {
  static int resident[64] = {};
  if (cap > 0) {
    const int tiles = (cap + kScanTile - 1) / kScanTile;
    compact_kernel<<<min(tiles, resident_blocks(compact_kernel, kScanThreads,
                                                resident)),
                     kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        cap, mask, limit, out, count, scratch);
  }
  return static_cast<int>(cudaGetLastError());
}

// W2's grid: its tiles over the capacity, at most the blocks resident at
// once.  The [*, 3] outputs must be 16-byte aligned (tiles store whole
// 16-byte words).
extern "C" int wave_gather_clip_launch(
    int cap, const int* count, const float* rays_o, const float* rays_d,
    const int* lanes, int* pos, float hi_x, float hi_y,
    float hi_z, float center_x, float center_y, float center_z,
    float scale_xy, float eps, float* clipped, float* dirs,
    float* entry_normal, float* tminn, unsigned char* ok, void* stream) {
  static int resident[64] = {};
  const Box box{{hi_x, hi_y, hi_z}, {center_x, center_y, center_z}, scale_xy,
                eps};
  if ((reinterpret_cast<unsigned long long>(clipped) |
       reinterpret_cast<unsigned long long>(dirs) |
       reinterpret_cast<unsigned long long>(entry_normal)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cap > 0) {
    const int tiles = (cap + kGatherTile - 1) / kGatherTile;
    gather_clip_kernel<<<min(tiles, resident_blocks(gather_clip_kernel,
                                                    kGatherTile, resident)),
                         kGatherTile, 0, static_cast<cudaStream_t>(stream)>>>(
        count, rays_o, rays_d, lanes, pos, box, clipped, dirs,
        entry_normal, tminn, ok);
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
    float* resume_t, unsigned long long* scratch, void* stream) {
  static int resident[64] = {};
  const Box box{{hi_x, hi_y, hi_z}, {center_x, center_y, center_z}, scale_xy,
                eps};
  const bm::TraverseParams P{cells_x, cells_y, cells_z, sc_size, sc_xy,
                             num_sc,  cam_x,   cam_y,   cam_z,   lod8,
                             lod2,    brick_size, epsilon, budget};
  const Rescued res{hit, request, exhausted, t, normal, resume_t,
                    request_pos};
  if (cap > 0) {
    const int need = (cap + kRescueThreads - 1) / kRescueThreads;
    rescue_kernel<<<min(need, resident_blocks(rescue_kernel, kRescueThreads,
                                              resident, kRescueBlocksPerSm)),
                    kRescueThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        count, rows, lanes, rays_o, rays_d, box, P, passes,
        index_volume, pool_words, pool_base, res,
        reinterpret_cast<int*>(scratch));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wave_shade_launch(
    int n, int bounce, int max_bounces, int final_pass, float* rays_o,
    float* rays_d, unsigned char* live, int* pos, const unsigned char* hit,
    const float* t, const float* normal, const unsigned char* request,
    const int* request_pos, const unsigned char* exhausted, float* sh_color,
    float* accum, unsigned char* req_mask, int* req_pos,
    unsigned long long* counters, const float* cone1, const float* cone2,
    const float* hemi1, const float* hemi2, const float* sun_dir,
    const float* sky, float eps2, const long long* dst, float* rgb,
    float* count, unsigned char* mask, int* pos_out, void* stream) {
  const Traced res{hit, request, exhausted, t, normal, request_pos};
  const Samples u{cone1, cone2, hemi1, hemi2};
  const Outputs out{dst, rgb, count, mask, pos_out};
  if (n > 0) {
    shade_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        n, bounce, max_bounces, final_pass, rays_o, rays_d, live, pos, res,
        sh_color, accum, req_mask, req_pos, counters, u, sun_dir, sky, eps2,
        out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wave_blit_launch(int n, const float* rgb, const float* count,
                                unsigned char* out, void* stream) {
  if (n > 0) {
    blit_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(n, rgb, count, out);
  }
  return static_cast<int>(cudaGetLastError());
}
