// Kernels W0-W4: the sample wave's stages around the traversal (B2), one
// CUDA thread per lane, ray or row.
//
// They have no Pallas twin: the JAX package leaves these stages to XLA,
// which fuses each jitted stage into a few device programs.
//   W0 compact_*_kernel    the pack index of _compact_trace (:59), a cumsum
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
// The plain versions are brickmap_tpu_torch/ops/wave.py; each kernel
// rounds every operation as that torch code does on the same device.
//
// No host round trip.  The JAX wave picks its compaction bucket with
// lax.switch and gates its rescue with lax.cond, both on device counts.
// Here W0 writes the count on the device and W2, B2 and W4 read it there:
// each launch covers the capacity (the wave's 2N rays, or a trace's
// compacted ones) and a thread past the count returns at once.  A trace is
// W0 -> W2 -> B2 -> W0 (exhausted) -> W4 with nothing copied to the host;
// when nothing is exhausted, W4's threads all return.  W0 is two launches:
// each 4096-row tile's count, then each tile's offset (the block sums the
// counts of the tiles before it), the rows' ranks from a block scan, and
// the writes.  A ray is independent of the others in a rescue pass, so
// W4 runs a ray's passes back to back in one thread, in the passes' float
// operations and order: its results equal the host loop's bit for bit.
//
// What bounds them on an H100: bytes.  W3 does ~400 float operations a lane
// (three sky evaluations' exp/acos/pow, two cosines and sines, square
// roots) and moves ~230 bytes, so at 67 TFLOP/s and 3.35 TB/s its bytes
// take ~10x longer; W1 and W2 move 120 and 77 bytes a lane with less
// arithmetic, W0 a byte a row and 4 a set row.  W4 is B2's walk, bound
// as B2 is.  The design therefore keeps every lane's state in device
// memory exactly once a stage: W1 writes the wave's [2N] ray buffers and
// state in place; W2 writes B2's inputs directly (no separate gather, clip
// or copy to contiguous); W3 reads B2's compacted results through W2's
// position map (no scatter into full-size tensors) and writes the next
// bounce's rays into the same [2N] buffers (no concatenation), and on the
// last pass writes the wave's outputs through the tile permutation.  A
// lane's loads and stores are 4-byte words at neighbouring addresses across
// a warp; the ray counters are summed in the block and added with one
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

// The rays at rows lanes[k], k < *count (W0's compaction), clipped to the
// world box.
__global__ void __launch_bounds__(kThreads)
gather_clip_kernel(const int* __restrict__ count,
                   const float* __restrict__ rays_o,
                   const float* __restrict__ rays_d,
                   const int* __restrict__ lanes, int* __restrict__ pos,
                   Box box, float* __restrict__ clipped,
                   float* __restrict__ dirs,
                   float* __restrict__ entry_normal,
                   float* __restrict__ tminn_out,
                   unsigned char* __restrict__ ok) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= *count) return;
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

extern "C" int wave_gather_clip_launch(
    int cap, const int* count, const float* rays_o, const float* rays_d,
    const int* lanes, int* pos, float hi_x, float hi_y,
    float hi_z, float center_x, float center_y, float center_z,
    float scale_xy, float eps, float* clipped, float* dirs,
    float* entry_normal, float* tminn, unsigned char* ok, void* stream) {
  const Box box{{hi_x, hi_y, hi_z}, {center_x, center_y, center_z}, scale_xy,
                eps};
  if (cap > 0) {
    gather_clip_kernel<<<(cap + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
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
