// K2 and K3: watershed label resolution on the H100.
//
// Replaces tpuseg/ops/pallas_resolve.py:chase_pass (_chase_kernel) and
// tpuseg/ops/pallas_resolve.py:flood_pass (_flood_kernel). The TPU kernels
// iterate inside a VMEM window with a halo of `iters`, because device-memory
// round trips dominated there. The same holds here, and each kernel answers
// it in its own way; neither keeps the TPU's block shapes.
//
// chase (K2): a pass is `iters` lockstep steps V[x] <- V[x + off(dirs[x])].
// The codes do not change within a pass, so the pass is one hop walk
// (common.cuh: chase_walk_kernel): one launch, each value read once where
// the walk ends, 13 bytes per voxel from device memory whatever `iters` is.
// The same launch counts the foreground voxels left at 0 (__syncthreads_count
// and one atomicAdd per block), so the host reads a single int per pass.
//
// flood (K3): a pass is `iters` lockstep steps of the seeded flood, run
// kFloodSteps at a time in shared memory (flood.cuh: flood_march_kernel), so
// a pass of 8 is two launches and two trips through device memory. A pass of
// more than kFloodSteps steps alternates between `l_out` and `l_tmp`; the
// last launch takes the remainder. "Changed" is a device flag that any
// launch of the pass sets and the host reads once per pass: labels never
// revert, so the pass's output differs from its input iff some step took.
#include "flood.cuh"

namespace tpuseg {
namespace {

// Steps per launch and the block's tile: 4 steps on a 32 x 32 tile (window
// 40 x 40, six planes of 9 bytes a position: 86 KB, two blocks an SM), one
// thread for each of a plane's 400 quads. The fastest of the steps and
// tiles tried (tools/resolve_variants.py).
constexpr int kFloodSteps = 4;
constexpr int kFloodTileY = 32, kFloodTileX = 32, kFloodThreads = 416;

}  // namespace
}  // namespace tpuseg

using namespace tpuseg;

// `iters` chase steps from v_in into v_out (no alias). *count receives the
// number of foreground voxels left at 0.
extern "C" int tpuseg_chase_pass(const int* v_in, const int* dirs,
                                 const unsigned char* fg, int* v_out,
                                 int* count, int iters, int D, int H, int W,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  return run_chase(v_in, dirs, v_out, fg, count, iters, D, H, W, s);
}

// The most flood steps one launch runs: a pass of more needs l_tmp.
extern "C" int tpuseg_flood_steps_per_launch() { return kFloodSteps; }

// `iters` flood steps from l_in into l_out. l_tmp is scratch for passes of
// more than tpuseg_flood_steps_per_launch() steps (else unused, may be
// null); neither may alias l_in. *changed is 1 if any step changed any
// label, else 0.
extern "C" int tpuseg_flood_pass(const float* pot, const int* l_in,
                                 int* l_out, int* l_tmp, int* changed,
                                 int iters, int D, int H, int W,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  const int launches = (iters + kFloodSteps - 1) / kFloodSteps;
  if (launches > 1 && l_tmp == nullptr) return cudaErrorInvalidValue;
  const int* src = l_in;
  for (int k = 0; k < launches; ++k) {
    // alternate so that the last launch writes l_out
    int* dst = ((launches - 1 - k) % 2 == 0) ? l_out : l_tmp;
    const int h = min(kFloodSteps, iters - k * kFloodSteps);
    err = launch_flood<kFloodSteps, kFloodTileY, kFloodTileX, kFloodThreads>(
        pot, src, dst, changed, h, D, H, W, s);
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}
