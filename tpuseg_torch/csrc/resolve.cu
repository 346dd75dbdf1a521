// K2 and K3: watershed label resolution on the H100.
//
// Replaces tpuseg/ops/pallas_resolve.py:chase_pass (_chase_kernel) and
// tpuseg/ops/pallas_resolve.py:flood_pass (_flood_kernel).
//
// chase: a pass is `iters` lockstep steps V[x] <- V[x + off(dirs[x])]. Each
// step reads 12 bytes per voxel (dirs, own value, the pointed-at value; the
// last two mostly hit L1/L2) and writes 4: at 3.35 TB/s a step over the
// 96x512x512 stack costs at least ~0.12 ms from HBM. The last step of a pass
// also counts unresolved foreground voxels (one more byte per voxel) with
// __syncthreads_count and one atomicAdd per block, so the host reads a single
// int per pass instead of reducing the volume.
//
// flood: a pass is `iters` lockstep steps of the seeded flood. Each step
// reads the label and potential of the voxel and of its six neighbours (the
// neighbours' mostly from cache: ~8 bytes per voxel from HBM) and writes 4.
// Labelled and background voxels return after one load of each array.
// "Changed" is a device flag set by any step of the pass and read once per
// pass by the host.
//
// The TPU kernels iterate inside VMEM windows because HBM round trips
// dominated there; here every step is one launch over the whole volume with
// ping-pong buffers (lockstep, not in-place: an in-place update would reach
// other states when the loop is capped). Keeping several steps in shared
// memory is later work.
#include "common.cuh"

namespace tpuseg {
namespace {

// One lockstep flood step. `pot` is -inf off the foreground. An unlabelled
// foreground voxel takes the label of its labelled (> 0) neighbour with the
// largest (potential, linear index); labelled voxels never change.
__global__ void flood_step_kernel(const float* __restrict__ pot,
                                  const int* __restrict__ in,
                                  int* __restrict__ out,
                                  int* __restrict__ changed,
                                  int D, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const int y = blockIdx.y;
  const int z = blockIdx.z;
  const int i = (z * H + y) * W + x;
  const int lab = in[i];
  int res = lab;
  if (lab == 0 && pot[i] > -CUDART_INF_F) {
    float best_key = -CUDART_INF_F;
    int best_idx = -1;
    int best_lbl = 0;
    for (int c = 1; c <= 6; ++c) {
      const int j = neighbor(c, i, z, y, x, D, H, W);
      if (j < 0) continue;
      const int nl = in[j];
      if (nl <= 0) continue;
      const float key = pot[j];
      if (key > best_key || (key == best_key && j > best_idx)) {
        best_key = key;
        best_idx = j;
        best_lbl = nl;
      }
    }
    if (best_lbl > 0) res = best_lbl;
  }
  out[i] = res;
  if (res != lab) *changed = 1;  // every writer stores the same value
}

}  // namespace
}  // namespace tpuseg

using namespace tpuseg;

// `iters` chase steps from v_in into v_out (v_tmp is scratch; neither may
// alias v_in). *count receives the number of foreground voxels left at 0.
extern "C" int tpuseg_chase_pass(const int* v_in, const int* dirs,
                                 const unsigned char* fg, int* v_out,
                                 int* v_tmp, int* count, int iters, int D,
                                 int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  return run_chase(v_in, dirs, v_out, v_tmp, fg, count, iters, D, H, W, s);
}

// `iters` flood steps from l_in into l_out (l_tmp is scratch; neither may
// alias l_in). *changed is 1 if any step changed any label, else 0.
extern "C" int tpuseg_flood_pass(const float* pot, const int* l_in,
                                 int* l_out, int* l_tmp, int* changed,
                                 int iters, int D, int H, int W,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  const dim3 grid = volume_grid(D, H, W);
  const int* src = l_in;
  for (int k = 0; k < iters; ++k) {
    int* dst = pingpong_dst(k, iters, l_out, l_tmp);
    flood_step_kernel<<<grid, kThreads, 0, s>>>(pot, src, dst, changed, D, H,
                                                W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}
