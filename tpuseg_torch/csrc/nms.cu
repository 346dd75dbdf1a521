// K5: fused 3D peak NMS on the H100.
//
// Replaces tpuseg/ops/pallas_nms.py:pallas_peak_nms (_nms_kernel): the seed
// mask of ops/peaks.peak_nms —
//
//   seeds = peak >= thr  &  peak >= (2r+1)^3 max of peak (-inf outside)
//           &  own linear index == largest candidate index in the window
//
// float32 in, one byte (0/1) out, radius per axis. One launch of nms.cuh's
// tile pass: a block stages a (y, x) window of the peak map with a halo of
// 2r (a candidate's own window reaches 2r from the core; with r alone a
// plateau across a window's edge loses its seed), marches over z four
// planes a step with the two z windows in registers and the next step's
// planes on their way (cp.async), and writes the mask; no intermediate reaches
// device memory and no scratch volume is allocated. The TPU kernel pads the
// volume and falls back to XLA for shapes its blocks do not divide; here
// window entries outside the volume are filled by coordinate and every
// (D, H, W) is taken.
//
// Radii above nms.cuh's kTileMaxR take the chain of whole-volume launches
// (tpuseg_peak_nms_chain: up to seven pooling and candidate launches and a
// compare, through five volume-sized scratch buffers); the wrapper decides
// from the radius before any launch.
//
// Bound: memory, 4 bytes read and 1 written per voxel. The tile pass reads
// the window (1.56x the core at r = 2) and writes the byte; the chain moved
// ~8 bytes per voxel in each launch. The pass itself is bound by its
// shared-memory loads and the schedulers' slots (nms.cuh).
#include "nms.cuh"

namespace tpuseg {
namespace {

// The chain's last step.
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

// The largest per-axis radius of the tile pass, its dynamic shared memory
// for (ry, rx) in bytes, and the most a block may opt in to on this device
// (a negative CUDA error code on failure).
extern "C" int tpuseg_nms_tile_max_radius() { return kTileMaxR; }

extern "C" int tpuseg_nms_tile_smem(int ry, int rx) {
  return nms_tile_smem(ry, rx);
}

extern "C" int tpuseg_smem_optin() {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// seeds (one byte per voxel, 0/1) of the contiguous float32 (D, H, W) map
// `peak` by the tile pass; every radius <= tpuseg_nms_tile_max_radius().
// *thr: the threshold, in device memory (the host never reads it).
extern "C" int tpuseg_peak_nms(const float* peak, const float* thr, int rz,
                               int ry, int rx, int D, int H, int W,
                               unsigned char* seeds, void* stream) {
  return launch_nms_tile<false>(peak, nullptr, thr, rz, ry, rx, D, H, W,
                                seeds, nullptr, nullptr,
                                static_cast<cudaStream_t>(stream));
}

// The same by the chain, for any radius. Scratch: f0, f1 (float) and cidx,
// i0, i1 (int), volume sized.
extern "C" int tpuseg_peak_nms_chain(const float* peak, const float* thr,
                                     int rz,
                                     int ry, int rx, int D, int H, int W,
                                     float* f0, float* f1, int* cidx, int* i0,
                                     int* i1, unsigned char* seeds,
                                     void* stream) {
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
