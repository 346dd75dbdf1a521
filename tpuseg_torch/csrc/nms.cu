// K5: fused 3D peak NMS on the H100.
//
// Replaces tpuseg/ops/pallas_nms.py:pallas_peak_nms (_nms_kernel): the seed
// mask of ops/peaks.peak_nms —
//
//   seeds = peak >= thr  &  peak >= (2r+1)^3 max of peak (-inf outside)
//           &  own linear index == largest candidate index in the window
//
// float32 in, one byte (0/1) out, radius per axis. The candidate steps are
// nms.cuh's chain of separable whole-volume launches, shared with the fused
// seed pass (seed.cu); this file adds the final compare. The TPU kernel
// stages a block with a 2r halo in VMEM (a candidate's own window reaches 2r
// from the core) and falls back to XLA for shapes its blocks do not divide;
// here every launch sees the whole volume, so there is no halo to size and
// every (D, H, W) is taken.
//
// Bound: memory. The function must read 4 bytes and write 1 per voxel; this
// version moves about 8 bytes per voxel in each of up to 7 pooling and
// candidate launches (the 2r window along an axis comes from cache) plus 9 in
// the compare. One shared-memory tile pass with a 2r halo would come close
// to the 5 bytes; that is later work.
#include "nms.cuh"

namespace tpuseg {
namespace {

__global__ void seed_mask_kernel(const int* __restrict__ cidx,
                                 const int* __restrict__ midx,
                                 unsigned char* __restrict__ seeds, int D,
                                 int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const int i = (blockIdx.z * H + blockIdx.y) * W + x;
  const int c = cidx[i];
  seeds[i] = (c >= 0 && c == midx[i]) ? 1 : 0;
}

}  // namespace
}  // namespace tpuseg

using namespace tpuseg;

// seeds (one byte per voxel, 0/1) of the contiguous float32 (D, H, W) map
// `peak`. Scratch: f0, f1 (float) and cidx, i0, i1 (int), volume sized.
extern "C" int tpuseg_peak_nms(const float* peak, float thr, int rz, int ry,
                               int rx, int D, int H, int W, float* f0,
                               float* f1, int* cidx, int* i0, int* i1,
                               unsigned char* seeds, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int radius[3] = {rz, ry, rx};
  cudaError_t err;
  const int* midx = nms_candidates(peak, thr, radius, f0, f1, cidx, i0, i1, D,
                                   H, W, s, &err);
  if (err != cudaSuccess) return err;
  seed_mask_kernel<<<volume_grid(D, H, W), kThreads, 0, s>>>(cidx, midx, seeds,
                                                             D, H, W);
  return cudaGetLastError();
}
