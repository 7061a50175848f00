// Native worldgen: perm-table simplex fBm heightfield, multithreaded.
//
// The port's own copy of csrc/worldgen.cpp (the JAX package's heightfield),
// kept byte-for-byte in its arithmetic so both packages build the identical
// world when compiled with the same flags.  The unit of work is a row of the
// heightfield; brick packing runs as torch ops on the scene's device
// (brickmap_tpu_torch/scene.py).
//
// The noise algorithm (skew/unskew simplex with Perlin's permutation table)
// matches brickmap_tpu_torch/noise.py operation-for-operation in float32 so
// native and NumPy worlds agree to float rounding.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

const uint8_t kPerm[256] = {
    151, 160, 137, 91,  90,  15,  131, 13,  201, 95,  96,  53,  194, 233, 7,
    225, 140, 36,  103, 30,  69,  142, 8,   99,  37,  240, 21,  10,  23,  190,
    6,   148, 247, 120, 234, 75,  0,   26,  197, 62,  94,  252, 219, 203, 117,
    35,  11,  32,  57,  177, 33,  88,  237, 149, 56,  87,  174, 20,  125, 136,
    171, 168, 68,  175, 74,  165, 71,  134, 139, 48,  27,  166, 77,  146, 158,
    231, 83,  111, 229, 122, 60,  211, 133, 230, 220, 105, 92,  41,  55,  46,
    245, 40,  244, 102, 143, 54,  65,  25,  63,  161, 1,   216, 80,  73,  209,
    76,  132, 187, 208, 89,  18,  169, 200, 196, 135, 130, 116, 188, 159, 86,
    164, 100, 109, 198, 173, 186, 3,   64,  52,  217, 226, 250, 124, 123, 5,
    202, 38,  147, 118, 126, 255, 82,  85,  212, 207, 206, 59,  227, 47,  16,
    58,  17,  182, 189, 28,  42,  223, 183, 170, 213, 119, 248, 152, 2,   44,
    154, 163, 70,  221, 153, 101, 155, 167, 43,  172, 9,   129, 22,  39,  253,
    19,  98,  108, 110, 79,  113, 224, 232, 178, 185, 112, 104, 218, 246, 97,
    228, 251, 34,  242, 193, 238, 210, 144, 12,  191, 179, 162, 241, 81,  51,
    145, 235, 249, 14,  239, 107, 49,  192, 214, 31,  181, 199, 106, 157, 184,
    84,  204, 176, 115, 121, 50,  45,  127, 4,   150, 254, 138, 236, 205, 93,
    222, 114, 67,  29,  24,  72,  243, 141, 128, 195, 78,  66,  215, 61,  156,
    180};

inline uint8_t hash8(int32_t i) { return kPerm[static_cast<uint8_t>(i)]; }

inline float grad2(int32_t h, float x, float y) {
  h &= 0x3F;
  const float u = h < 4 ? x : y;
  const float v = h < 4 ? y : x;
  return ((h & 1) ? -u : u) + ((h & 2) ? -2.0f * v : 2.0f * v);
}

constexpr float kF2 = 0.366025403f;
constexpr float kG2 = 0.211324865f;

float simplex2(float x, float y) {
  const float s = (x + y) * kF2;
  const int32_t i = static_cast<int32_t>(std::floor(x + s));
  const int32_t j = static_cast<int32_t>(std::floor(y + s));
  const float t = static_cast<float>(i + j) * kG2;
  const float x0 = x - (static_cast<float>(i) - t);
  const float y0 = y - (static_cast<float>(j) - t);
  const int32_t i1 = x0 > y0 ? 1 : 0;
  const int32_t j1 = 1 - i1;
  const float x1 = x0 - static_cast<float>(i1) + kG2;
  const float y1 = y0 - static_cast<float>(j1) + kG2;
  const float x2 = x0 - 1.0f + 2.0f * kG2;
  const float y2 = y0 - 1.0f + 2.0f * kG2;

  const int32_t gi0 = hash8(i + hash8(j));
  const int32_t gi1 = hash8(i + i1 + hash8(j + j1));
  const int32_t gi2 = hash8(i + 1 + hash8(j + 1));

  float n = 0.0f;
  float tt = 0.5f - x0 * x0 - y0 * y0;
  if (tt >= 0.0f) {
    tt *= tt;
    n += tt * tt * grad2(gi0, x0, y0);
  }
  tt = 0.5f - x1 * x1 - y1 * y1;
  if (tt >= 0.0f) {
    tt *= tt;
    n += tt * tt * grad2(gi1, x1, y1);
  }
  tt = 0.5f - x2 * x2 - y2 * y2;
  if (tt >= 0.0f) {
    tt *= tt;
    n += tt * tt * grad2(gi2, x2, y2);
  }
  return 45.23065f * n;
}

float fbm2(float x, float y, int octaves, float lacunarity, float persistence) {
  float out = 0.0f, denom = 0.0f, freq = 1.0f, amp = 1.0f;
  for (int o = 0; o < octaves; ++o) {
    out += amp * simplex2(x * freq, y * freq);
    denom += amp;
    freq *= lacunarity;
    amp *= persistence;
  }
  return out / denom;
}

}  // namespace

extern "C" {

// Fill heights[y * grid_size + x] = fbm(x/scale, y/scale) * H/2 + H/2 for the
// whole grid, work-stealing rows across hardware threads (the reference's
// thread fan-out pattern, Scene.cpp:124-147).
void terrain_heights(int grid_size, int grid_height, int octaves,
                     float feature_scale, float* heights) {
  const unsigned hw = std::thread::hardware_concurrency();
  const unsigned nthreads = hw ? hw : 1;
  std::atomic<int> next_row{0};
  const float half = static_cast<float>(grid_height) / 2.0f;

  auto worker = [&]() {
    for (;;) {
      const int y = next_row.fetch_add(1);
      if (y >= grid_size) return;
      const float fy = static_cast<float>(y) / feature_scale;
      float* row = heights + static_cast<size_t>(y) * grid_size;
      for (int x = 0; x < grid_size; ++x) {
        const float fx = static_cast<float>(x) / feature_scale;
        row[x] = fbm2(fx, fy, octaves, 2.0f, 0.5f) * half + half;
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (unsigned t = 0; t < nthreads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// Scalar probe for tests.
float simplex2_at(float x, float y) { return simplex2(x, y); }

}  // extern "C"
