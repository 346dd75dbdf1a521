// K2 and K3: watershed label resolution on the H100.
//
// Replaces tpuseg/ops/pallas_resolve.py:chase_pass (_chase_kernel) and
// tpuseg/ops/pallas_resolve.py:flood_pass (_flood_kernel), and the
// lax.while_loops around them (chase_resolve, flood_resolve). The TPU
// kernels iterate inside a VMEM window with a halo of `iters`, because
// device-memory round trips dominated there. The same holds here, and each
// kernel answers it in its own way; neither keeps the TPU's block shapes.
//
// chase (K2): a pass is `iters` lockstep steps V[x] <- V[x + off(dirs[x])].
// The codes do not change within a pass, so the pass is one hop walk
// (common.cuh: walk_value): one launch, each value read once where the walk
// ends, 13 bytes per voxel from device memory whatever `iters` is. The same
// launch counts the foreground voxels left at 0 (one atomicAdd a warp).
//
// flood (K3): a pass is `iters` lockstep steps of the seeded flood, run
// kFloodSteps at a time in shared memory (flood.cuh: flood_march_kernel), so
// a pass of 8 is two launches and two trips through device memory. A pass of
// more than kFloodSteps steps alternates between `l_out` and `l_tmp`; the
// last launch takes the remainder. "Changed" is a device flag that any
// launch of the pass sets: labels never revert, so the pass's output
// differs from its input iff some step took.
//
// The loops run on the device, as the reference's lax.while_loops do: the
// host enqueues every pass the loop may run (the chase's max_passes, the
// flood's whole passes and its remainder) and each pass reads the previous
// pass's count or flag, its gate, from a slot of its own in an int array
// zeroed once, so no pass clears the gate it reads and the host reads
// nothing. A pass whose gate is 0 does nothing, so the loops stop where the
// reference's stop and run at most as many passes:
//   chase: pass k runs iff pass k-1 left a foreground voxel at 0 (slot 0:
//     the count before the first pass), up to max_passes;
//   flood: whole pass k runs iff pass k-1 changed a label (slot 0 holds 1),
//     then the remainder iff the last whole pass did (ungated with no whole
//     pass).
// The result must be in the buffer the last enqueued pass writes. A flood
// pass that changed nothing left its output equal to its input, so both
// ping-pong buffers hold the result when a gate first reads 0. A chase pass
// always writes a new buffer, so the first idle pass copies its input to
// its output: after that both buffers hold the result (the first pass reads
// the caller's volume, so passes 1 and 2 copy when idle).
//
// An idle pass must cost little: on the seeded-weights map of 96x512x512
// the chase runs 23 of its 128 passes. The walk's own grid is one thread a
// voxel (about 2 x 10^5 blocks), and even blocks that only read the gate and
// return take the block scheduler's time: 122 us a pass. So the pass kernel
// (common.cuh: chase_pass_kernel) has a block for each (32, 4) tile of a
// plane, which walks its tile down a chunk of planes: about four blocks for
// each the card holds at once (8192 at 96x512x512), so the idle pass is a
// launch of a few thousand blocks, and a pass that runs walks each voxel as
// the one-thread-a-voxel kernel does.
#include "flood.cuh"

namespace tpuseg {
namespace {

// Steps per launch and the block's tile: 4 steps on a 32 x 32 tile (window
// 40 x 40, six planes of 9 bytes a position: 86 KB, two blocks an SM), one
// thread for each of a plane's 400 quads. The fastest of the steps and
// tiles tried (tools/resolve_variants.py).
constexpr int kFloodSteps = 4;
constexpr int kFloodTileY = 32, kFloodTileX = 32, kFloodThreads = 416;

// One flood pass of `iters` steps from l_in into l_out (see
// tpuseg_flood_pass), every launch gated on *gate (null: always).
cudaError_t flood_pass_launches(const float* pot, const int* l_in, int* l_out,
                                int* l_tmp, int* changed, const int* gate,
                                int iters, int D, int H, int W,
                                cudaStream_t s) {
  const int launches = (iters + kFloodSteps - 1) / kFloodSteps;
  if (launches > 1 && l_tmp == nullptr) return cudaErrorInvalidValue;
  const int* src = l_in;
  for (int k = 0; k < launches; ++k) {
    // alternate so that the last launch writes l_out
    int* dst = ((launches - 1 - k) % 2 == 0) ? l_out : l_tmp;
    const int h = min(kFloodSteps, iters - k * kFloodSteps);
    const cudaError_t err =
        launch_flood<kFloodSteps, kFloodTileY, kFloodTileX, kFloodThreads>(
            pot, src, dst, changed, h, D, H, W, s, gate);
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

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
  return launch_chase_pass(v_in, dirs, v_out, fg, count, nullptr, nullptr,
                           iters, D, H, W, s);
}

// The chase loop on the device: max_passes gated passes of `iters` steps.
// Pass k (1-based) reads v_in (k = 1) or the buffer pass k-1 wrote, writes
// b1 (k odd) or b2 (k even; unused when max_passes is 1), runs iff
// flags[k-1] != 0 and adds its unresolved count to flags[k]. flags: max_passes
// + 1 ints, flags[0] the count of foreground zeros in v_in, the rest 0. The
// result is in the buffer pass max_passes writes; pass k ran iff
// flags[0..k-1] are all nonzero.
extern "C" int tpuseg_chase_resolve(const int* v_in, const int* dirs,
                                    const unsigned char* fg, int* b1, int* b2,
                                    int* flags, int iters,
                                    int max_passes, int D, int H, int W,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_passes > 1 && b2 == nullptr) return cudaErrorInvalidValue;
  for (int k = 1; k <= max_passes; ++k) {
    const int* src = k == 1 ? v_in : (k % 2 == 0 ? b1 : b2);
    int* dst = k % 2 == 1 ? b1 : b2;
    const cudaError_t err = launch_chase_pass(
        src, dirs, dst, fg, flags + k, flags + k - 1,
        k <= 2 ? nullptr : flags + k - 2, iters, D, H, W, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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
  return flood_pass_launches(pot, l_in, l_out, l_tmp, changed, nullptr,
                             iters, D, H, W, s);
}

// The flood loop on the device: `full` gated passes of iters_per_pass steps,
// then the remainder of `rem` steps (none if rem is 0). Whole pass k
// (1-based) reads b0 (k odd) or b1 (k even) and writes the other, runs iff
// flags[k-1] != 0 and sets flags[k] if it changed a label; the remainder
// reads the last whole pass's output, writes the other buffer and is gated
// on flags[full]. flags: full + 2 ints, flags[0] = 1, the rest 0. l_tmp:
// scratch for a pass of more than tpuseg_flood_steps_per_launch() steps.
// b0 (the seed labels) is overwritten. Pass k ran iff flags[0..k-1] are
// all nonzero.
extern "C" int tpuseg_flood_resolve(const float* pot, int* b0, int* b1,
                                    int* l_tmp, int* flags,
                                    int iters_per_pass, int full, int rem,
                                    int D, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* bufs[2] = {b0, b1};
  for (int k = 1; k <= full + (rem > 0); ++k) {
    const int iters = k <= full ? iters_per_pass : rem;
    const cudaError_t err = flood_pass_launches(
        pot, bufs[(k + 1) % 2], bufs[k % 2], l_tmp, flags + k, flags + k - 1,
        iters, D, H, W, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
