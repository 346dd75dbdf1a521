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

// in[p^iters(x, y, z)]: the value `iters` lockstep chase steps bring to
// voxel (x, y, z). The walk ends early at a code outside 1..6 (0 = self: a
// fixed point) and yields 0 as soon as a hop leaves the volume (the Pallas
// kernel's zero pad: padded voxels hold value 0 and code 0).
__device__ __forceinline__ int walk_value(const int* __restrict__ in,
                                          const int* __restrict__ dirs, int x,
                                          int y, int z, int iters, int D,
                                          int H, int W) {
  const int HW = H * W;
  int cz = z, cy = y, cx = x, j = (z * H + y) * W + x;
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
  return inside ? __ldg(in + j) : 0;
}

// out[i] = in[p^iters(i)]: the result of `iters` lockstep chase steps (see
// walk_value). With `count` set, also adds the number of foreground voxels
// whose result is 0 (unresolved chains) to *count: one atomicAdd per block.
// `out` must not alias `in`.
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
    const int val = walk_value(in, dirs, x, y, z, iters, D, H, W);
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

// The chase pass's tile: the walk's block (chase_block()).
constexpr int kChaseTileX = 32, kChaseTileY = 4;
constexpr int kChaseThreads = kChaseTileX * kChaseTileY;
constexpr int kChaseWaves = 4;

// One chase pass of K2 (resolve.cu's header: the loop gated on the
// device): `iters` steps from `in` into `out` (no alias). Block (bx, by, bz) owns the walk's (32, 4) tile (bx, by) of every
// plane of its z chunk and walks them plane by plane, so the blocks in
// flight cover about one plane, as the one-block-a-tile grid's do, and no
// index is divided. `count`: where the unresolved-foreground count goes
// (may be null, with `fg`). `gate`: run iff *gate != 0 (null: always); an
// idle pass copies `in` to `out` iff `copy_gate` is null or *copy_gate !=
// 0.
__global__ void __launch_bounds__(kChaseThreads)
chase_pass_kernel(const int* __restrict__ in, const int* __restrict__ dirs,
                  int* __restrict__ out, const unsigned char* __restrict__ fg,
                  int* __restrict__ count, const int* __restrict__ gate,
                  const int* __restrict__ copy_gate, int iters, int zchunk,
                  int D, int H, int W) {
  const int tid = threadIdx.x;
  const int x = blockIdx.x * kChaseTileX + tid % kChaseTileX;
  const int y = blockIdx.y * kChaseTileY + tid / kChaseTileX;
  const int za = blockIdx.z * zchunk;
  const int zb = min(za + zchunk, D);
  const bool mine = x < W && y < H;
  if (gate != nullptr && *gate == 0) {  // uniform over the grid
    if (mine && (copy_gate == nullptr || *copy_gate != 0))
      for (int z = za; z < zb; ++z) {
        const int i = (z * H + y) * W + x;
        out[i] = __ldg(in + i);
      }
    return;
  }
  unsigned zeros = 0;
  if (mine)
    for (int z = za; z < zb; ++z) {
      const int i = (z * H + y) * W + x;
      const int val = walk_value(in, dirs, x, y, z, iters, D, H, W);
      out[i] = val;
      zeros += count != nullptr && fg[i] && val == 0;
    }
  if (count != nullptr) {  // one atomicAdd a block: they share an address
    __shared__ unsigned s_zeros[kChaseThreads / 32];
    const unsigned n = __reduce_add_sync(0xffffffffu, zeros);
    if ((tid & 31) == 0) s_zeros[tid / 32] = n;
    __syncthreads();
    if (tid == 0) {
      unsigned total = 0;
      for (int w = 0; w < kChaseThreads / 32; ++w) total += s_zeros[w];
      if (total > 0) atomicAdd(count, static_cast<int>(total));
    }
  }
}

// The chase pass's grid: a block for each (32, 4) tile of a plane, and z cut
// into chunks for about kChaseWaves blocks for each one the device holds at
// once. Fewer, longer blocks leave SMs idle while the last ones finish; more
// blocks cost an idle pass more, about 0.6 ns a block. At 96x512x512 on the
// seeded-weights load, in one run of tools/resolve_variants.py (NVIDIA H100
// 80GB HBM3, 700 W), a pass of 8 took 0.452 / 0.400 / 0.380 / 0.371 ms at
// one / two / four / eight waves (96 / 48 / 24 / 12 planes a block), and an
// idle pass timed alone 27.3 / 19.7 / 15.6 / 13.9 us. But the gated loop
// runs its idle passes back to back, where each costs by its blocks: all
// 128 passes idle took 0.94 / 0.96 / 1.26 / 1.87 ms, and the whole loop on
// that load (23 passes run) 10.95 / 9.91 / 9.71 / 10.01 ms. Four waves is
// the best loop on the main path's load, so it is kept; two would save
// 0.3 ms where nearly every pass is idle (a trained c5 call runs 1-2).
inline cudaError_t chase_grid(int D, int H, int W, dim3* grid, int* zchunk) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, chase_pass_kernel, kChaseThreads, 0);
    if (err != cudaSuccess) return err;
    resident = max(sms * per_sm, 1);
  }
  const int tx = (W + kChaseTileX - 1) / kChaseTileX;
  const int ty = (H + kChaseTileY - 1) / kChaseTileY;
  const int nz = max(min(kChaseWaves * resident / (tx * ty), D), 1);
  *zchunk = (D + nz - 1) / nz;
  *grid = dim3(tx, ty, (D + *zchunk - 1) / *zchunk);
  return cudaSuccess;
}

// One chase pass over the volume (chase_pass_kernel). `zchunk`: planes a
// block walks, 0 for chase_grid's rule (tools/resolve_variants.py times
// others).
inline cudaError_t launch_chase_pass(const int* in, const int* dirs, int* out,
                                     const unsigned char* fg, int* count,
                                     const int* gate, const int* copy_gate,
                                     int iters, int D, int H, int W,
                                     cudaStream_t s, int zchunk = 0) {
  dim3 grid;
  if (zchunk > 0) {
    grid = dim3((W + kChaseTileX - 1) / kChaseTileX,
                (H + kChaseTileY - 1) / kChaseTileY,
                (D + zchunk - 1) / zchunk);
  } else {
    const cudaError_t err = chase_grid(D, H, W, &grid, &zchunk);
    if (err != cudaSuccess) return err;
  }
  chase_pass_kernel<<<grid, kChaseThreads, 0, s>>>(
      in, dirs, out, fg, count, gate, copy_gate, iters, zchunk, D, H, W);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpuseg
