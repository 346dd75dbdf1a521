// K1: watershed seeding on the H100.
//
// Replaces tpuseg/ops/pallas_seed.py:seed_chase_pass (_seed_kernel):
//
//   fg    = fg_prob >= fg_thr
//   seeds = peak-NMS seeds (nms.cuh) & fg
//   dirs  = steepest ascent over (peak on fg, lin), 0 at seeds and off fg
//   v0    = +(lin+1) at seeded roots, -(lin+1) at unseeded roots, 0 elsewhere
//   v     = h0 lockstep chase steps (the K2 walk kernel: one launch)
//
// Two launches: nms.cuh's tile pass with DIRS set, which writes dirs and v0,
// and the walk from v0 into v. The tile pass holds everything between the
// peak map and the seeds on chip (the NMS cone: a halo of 2r, see nms.cuh
// for why r is not enough); the thread that learns a core voxel's seed
// status takes its ascent step on the spot, reading the two maps at the
// voxel and its six neighbours through L1/L2 (the chain's direction launch
// showed that these reads cost little), and writes dirs and v0. The TPU
// kernel's (8, 64) blocks, padded copy and static crop are not carried over:
// window entries outside the volume are filled by coordinate.
//
// Radii above nms.cuh's kTileMaxR take the chain of whole-volume launches
// instead (tpuseg_seed_chase_chain: the pooling chain, seed_dirs_kernel and
// the walk, through five volume-sized scratch buffers); the wrapper decides
// from the radius before any launch.
//
// Bound: memory. The function must move 16 bytes per voxel (two float32 maps
// in, two int32 volumes out). The tile pass reads peak ~1.6x for the pool
// and once more, with fg_prob, for the ascent step (mostly from L2), and
// writes dirs and v0; the walk reads both and writes v: about 36 bytes per
// voxel against the chain's ~120. The walk stays a launch of its own, so K1
// cannot come within 2x of its bound.
#include "nms.cuh"

namespace tpuseg {
namespace {

// The chain's last step: seeds, direction codes and the signed payload v0.
__global__ void seed_dirs_kernel(const float* __restrict__ peak,
                                 const float* __restrict__ fgp,
                                 const int* __restrict__ cidx,
                                 const int* __restrict__ midx,
                                 int* __restrict__ dirs, int* __restrict__ v0,
                                 const float* __restrict__ thrs, int D, int H,
                                 int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const float fg_thr = __ldg(thrs + 1);
  const int y = blockIdx.y;
  const int z = blockIdx.z;
  const int i = (z * H + y) * W + x;
  const bool fg = fgp[i] >= fg_thr;
  const int ci = cidx[i];
  const bool seed = fg && ci >= 0 && ci == midx[i];
  int code = 0;
  if (fg && !seed) {
    const bool has[6] = {z + 1 < D, z > 0, y + 1 < H, y > 0, x + 1 < W, x > 0};
    code = ascent_code(peak, fgp, fg_thr, i, H * W, W, has);
  }
  dirs[i] = code;
  v0[i] = (fg && code == 0) ? (seed ? i + 1 : -(i + 1)) : 0;
}

}  // namespace
}  // namespace tpuseg

using namespace tpuseg;

// (dirs, v) of pallas_seed.seed_chase_pass by the tile pass; every radius
// <= tpuseg_nms_tile_max_radius(). thrs: the peak and the foreground
// threshold, two floats in device memory (the host never reads them; the
// reference's traced scalars). v0 is volume-sized scratch, the result v
// lands in v_out.
extern "C" int tpuseg_seed_chase(const float* peak, const float* fgp,
                                 const float* thrs, int rz, int ry, int rx,
                                 int h0, int D, int H, int W, int* v0,
                                 int* dirs, int* v_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_nms_tile<true>(
      peak, fgp, thrs, rz, ry, rx, D, H, W, nullptr, dirs, v0, s);
  if (err != cudaSuccess) return err;
  return run_chase(v0, dirs, v_out, nullptr, nullptr, h0, D, H, W, s);
}

// The same by the chain, for any radius. Scratch: f0, f1 (float, volume
// sized) and cidx, i0, i1 (int, volume sized).
extern "C" int tpuseg_seed_chase_chain(const float* peak, const float* fgp,
                                       const float* thrs, int rz, int ry,
                                       int rx, int h0, int D, int H,
                                       int W, float* f0, float* f1, int* cidx,
                                       int* i0, int* i1, int* dirs,
                                       int* v_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = volume_grid(D, H, W);
  const int radius[3] = {rz, ry, rx};
  cudaError_t err;

  const int* midx = nms_candidates(peak, thrs, radius, f0, f1, cidx, i0, i1,
                                   D, H, W, s, &err);
  if (err != cudaSuccess) return err;

  // the pooled peak map in f0/f1 is dead once cidx exists: f0 holds v0
  int* v0 = reinterpret_cast<int*>(f0);
  seed_dirs_kernel<<<grid, kThreads, 0, s>>>(peak, fgp, cidx, midx, dirs, v0,
                                             thrs, D, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return run_chase(v0, dirs, v_out, nullptr, nullptr, h0, D, H, W, s);
}
