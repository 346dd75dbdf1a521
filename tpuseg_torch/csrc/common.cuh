// Shared pieces of the watershed kernels (seed.cu, resolve.cu).
//
// Volumes are contiguous row-major (D, H, W) arrays. Every kernel runs one
// thread per voxel: x on threadIdx.x / blockIdx.x (so a warp reads 32
// neighbouring words), y on blockIdx.y and z on blockIdx.z. Threads past the
// ragged x edge do nothing, so any (D, H, W) is taken; the Python wrappers
// check D, H <= 65535 (grid limits) and D*H*W < 2^31 (int32 linear index).
//
// Neighbour codes follow tpuseg/ops/neighbors.NEIGHBORS_6:
//   1: z+1   2: z-1   3: y+1   4: y-1   5: x+1   6: x-1   (0 = self)
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace tpuseg {
// Internal linkage: each .cu file compiles its own copy of these.
namespace {

constexpr int kThreads = 128;

inline dim3 volume_grid(int D, int H, int W) {
  return dim3((W + kThreads - 1) / kThreads, H, D);
}

// Linear index of neighbour `code` (1..6) of voxel i = (z*H + y)*W + x, or -1
// outside the volume.
__device__ __forceinline__ int neighbor(int code, int i, int z, int y, int x,
                                        int D, int H, int W) {
  switch (code) {
    case 1: return z + 1 < D ? i + H * W : -1;
    case 2: return z > 0 ? i - H * W : -1;
    case 3: return y + 1 < H ? i + W : -1;
    case 4: return y > 0 ? i - W : -1;
    case 5: return x + 1 < W ? i + 1 : -1;
    case 6: return x > 0 ? i - 1 : -1;
    default: return -1;
  }
}

// One lockstep pointer-chase step: out[i] = in[i + off(dirs[i])], 0 where the
// pointed-at voxel lies outside the volume (the Pallas kernel's zero pad).
// With `count` set, also adds the number of foreground voxels whose new value
// is 0 (unresolved chains) to *count: one atomicAdd per block.
__global__ void chase_step_kernel(const int* __restrict__ in,
                                  const int* __restrict__ dirs,
                                  int* __restrict__ out,
                                  const unsigned char* __restrict__ fg,
                                  int* __restrict__ count,
                                  int D, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int z = blockIdx.z;
  bool zero = false;
  if (x < W) {
    const int i = (z * H + y) * W + x;
    const int d = dirs[i];
    int val;
    if (d == 0) {
      val = in[i];
    } else {
      const int j = neighbor(d, i, z, y, x, D, H, W);
      val = j >= 0 ? in[j] : 0;
    }
    out[i] = val;
    zero = count != nullptr && fg[i] && val == 0;
  }
  if (count != nullptr) {  // uniform over the block: the barrier is safe
    const int n = __syncthreads_count(zero);
    if (threadIdx.x == 0 && n > 0) atomicAdd(count, n);
  }
}

// Buffer that step k of `iters` lockstep steps writes, so that the steps
// alternate between `out` and `tmp` and the last one writes `out`. The input
// of step 0 must be neither of the two, or the buffer step 0 does not write.
template <typename T>
inline T* pingpong_dst(int k, int iters, T* out, T* tmp) {
  return ((iters - 1 - k) % 2 == 0) ? out : tmp;
}

// `iters` chase steps from `in`; the result lands in `out`. `count` (may be
// null) receives the unresolved-foreground count of the last step.
inline cudaError_t run_chase(const int* in, const int* dirs, int* out,
                             int* tmp, const unsigned char* fg, int* count,
                             int iters, int D, int H, int W,
                             cudaStream_t stream) {
  const dim3 grid = volume_grid(D, H, W);
  const int* src = in;
  for (int k = 0; k < iters; ++k) {
    int* dst = pingpong_dst(k, iters, out, tmp);
    chase_step_kernel<<<grid, kThreads, 0, stream>>>(
        src, dirs, dst, fg, k == iters - 1 ? count : nullptr, D, H, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace tpuseg
