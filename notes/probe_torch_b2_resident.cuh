// Host code shared by the probe builds of kernel B2 with a resident grid
// (notes/probe_torch_b2_grid.cu, notes/probe_torch_b2_postpone.cu): the
// blocks of a kernel resident at once on the current device, as
// csrc/wave.cu sizes W0's, W2's and W4's grids.
#pragma once

namespace probe {

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

}  // namespace probe
