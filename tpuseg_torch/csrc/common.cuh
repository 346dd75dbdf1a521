// Shared pieces of the watershed kernels (seed.cu, resolve.cu, nms.cu).
//
// Volumes are contiguous row-major (D, H, W) arrays. The whole-volume kernels
// run one thread per voxel: x on threadIdx.x / blockIdx.x (so a warp reads 32
// neighbouring words), y on blockIdx.y (the walk: and threadIdx.y) and z on
// blockIdx.z. Threads past a ragged edge do nothing, so any (D, H, W) is
// taken; the Python wrappers check D, H <= 65535 (grid limits) and
// D*H*W < 2^31 (int32 linear index).
//
// Neighbour codes follow tpuseg/ops/neighbors.NEIGHBORS_6:
//   1: z+1   2: z-1   3: y+1   4: y-1   5: x+1   6: x-1   (0 = self)
//
// The pointer chase (K2; replaces tpuseg/ops/pallas_resolve.py:chase_pass,
// _chase_kernel) lives here because the seed pass (K1) ends in the same
// steps. `iters` lockstep steps V[x] <- V[x + off(dirs[x])] never change
// `dirs`, so together they are out[x] = in[p^iters(x)], p the parent map:
// chase_walk_kernel follows the codes for up to `iters` hops and reads `in`
// once, where it arrived. One launch a pass and no intermediate volume,
// whatever `iters` is. What bounds it on this card is bytes: per voxel it
// must read 4 (dirs) + 4 (the value it reaches) + 1 (mask) and write 4 from
// device memory; the hops' further reads of `dirs` stay within `iters`
// voxels of the thread's own and come from L1/L2, since the blocks in flight
// cover about one z plane and a few planes of codes fit in L2 many times.
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

// out[i] = in[p^iters(i)]: the result of `iters` lockstep chase steps. A walk
// ends early at a code outside 1..6 (0 = self: a fixed point) and yields 0 as
// soon as a hop leaves the volume (the Pallas kernel's zero pad: padded
// voxels hold value 0 and code 0). With `count` set, also adds the number of
// foreground voxels whose result is 0 (unresolved chains) to *count: one
// atomicAdd per block. `out` must not alias `in`.
__global__ void chase_walk_kernel(const int* __restrict__ in,
                                  const int* __restrict__ dirs,
                                  int* __restrict__ out,
                                  const unsigned char* __restrict__ fg,
                                  int* __restrict__ count, int iters,
                                  int D, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z * blockDim.z + threadIdx.z;
  bool zero = false;
  if (x < W && y < H && z < D) {
    const int i = (z * H + y) * W + x;
    const int HW = H * W;
    int cz = z, cy = y, cx = x, j = i;
    bool inside = true;
    for (int k = 0; k < iters; ++k) {
      const int d = __ldg(dirs + j);
      if (d < 1 || d > 6) break;
      const int dz = (d == 1) - (d == 2);
      const int dy = (d == 3) - (d == 4);
      const int dx = (d == 5) - (d == 6);
      cz += dz;
      cy += dy;
      cx += dx;
      inside = static_cast<unsigned>(cz) < static_cast<unsigned>(D) &&
               static_cast<unsigned>(cy) < static_cast<unsigned>(H) &&
               static_cast<unsigned>(cx) < static_cast<unsigned>(W);
      if (!inside) break;
      j += dz * HW + dy * W + dx;
    }
    const int val = inside ? __ldg(in + j) : 0;
    out[i] = val;
    zero = count != nullptr && fg[i] && val == 0;
  }
  if (count != nullptr) {  // uniform over the block: the barrier is safe
    const int n = __syncthreads_count(zero);
    if (threadIdx.x + threadIdx.y + threadIdx.z == 0 && n > 0)
      atomicAdd(count, n);
  }
}

// The walk's block, voxels in (x, y, z): the fastest of those tried on the
// main path's load (tools/resolve_variants.py).
inline dim3 chase_block() { return dim3(32, 4, 1); }

// `iters` chase steps from `in` into `out` (no alias) in one launch. `count`
// (may be null, and `fg` with it) receives the unresolved-foreground count.
inline cudaError_t run_chase(const int* in, const int* dirs, int* out,
                             const unsigned char* fg, int* count, int iters,
                             int D, int H, int W, cudaStream_t stream,
                             dim3 block = chase_block()) {
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y,
                  (D + block.z - 1) / block.z);
  chase_walk_kernel<<<grid, block, 0, stream>>>(in, dirs, out, fg, count,
                                                iters, D, H, W);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpuseg
