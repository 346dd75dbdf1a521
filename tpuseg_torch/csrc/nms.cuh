// Peak-NMS candidates, shared by the fused seed pass (seed.cu, K1) and the
// peak-NMS kernel (nms.cu, K5):
//
//   mx    = (2r+1)^3 max-pool of peak, -inf outside   (3 separable launches)
//   cidx  = lin where peak >= thr and peak >= mx, else -1
//   midx  = (2r+1)^3 max-pool of cidx, -1 outside     (3 separable launches)
//
// A voxel is a seed where cidx >= 0 and cidx == midx: on an exact plateau only
// the candidate with the largest linear index survives. The index pool runs
// on int32: linear indices of a 96x512x512 stack pass 2^24, where a float32
// pool would merge neighbouring candidates. Every launch is a whole-volume
// pass whose out-of-volume window entries are skipped, so any (D, H, W) and
// any per-axis radius (0 included) is taken and no tile halo is involved.
#pragma once

#include "common.cuh"

namespace tpuseg {
namespace {

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }

// Max over the window [p - r, p + r] along `axis` (0 = z, 1 = y, 2 = x);
// voxels outside the volume are skipped, which equals a fill below every
// value (-inf for the peak map, -1 for candidate indices).
template <typename T>
__global__ void maxpool_axis_kernel(const T* __restrict__ in,
                                    T* __restrict__ out, int axis, int r,
                                    int D, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const int y = blockIdx.y;
  const int z = blockIdx.z;
  const int i = (z * H + y) * W + x;
  const int p = axis == 0 ? z : (axis == 1 ? y : x);
  const int len = axis == 0 ? D : (axis == 1 ? H : W);
  const int stride = axis == 0 ? H * W : (axis == 1 ? W : 1);
  T m = in[i];
  for (int o = 1; o <= r; ++o) {
    if (p + o < len) m = vmax(m, in[i + o * stride]);
    if (p - o >= 0) m = vmax(m, in[i - o * stride]);
  }
  out[i] = m;
}

__global__ void candidate_index_kernel(const float* __restrict__ peak,
                                       const float* __restrict__ mx,
                                       int* __restrict__ cidx, float thr,
                                       int D, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const int i = (blockIdx.z * H + blockIdx.y) * W + x;
  const float v = peak[i];
  cidx[i] = (v >= thr && v >= mx[i]) ? i : -1;
}

// Separable max-pool of `src` over radius (rz, ry, rx), ping-ponging between
// buf0 and buf1; returns the buffer holding the result (src itself when every
// radius is 0).
template <typename T>
const T* maxpool3(const T* src, T* buf0, T* buf1, const int* radius, int D,
                  int H, int W, cudaStream_t stream, cudaError_t* err) {
  const dim3 grid = volume_grid(D, H, W);
  T* bufs[2] = {buf0, buf1};
  int k = 0;
  for (int axis = 2; axis >= 0; --axis) {
    if (radius[axis] == 0) continue;
    maxpool_axis_kernel<T><<<grid, kThreads, 0, stream>>>(
        src, bufs[k], axis, radius[axis], D, H, W);
    *err = cudaGetLastError();
    if (*err != cudaSuccess) return nullptr;
    src = bufs[k];
    k ^= 1;
  }
  *err = cudaSuccess;
  return src;
}

// Fills cidx and returns midx (in i0, i1 or, with every radius 0, cidx
// itself); nullptr with *err set when a launch fails. f0, f1 (float) and
// i0, i1 (int) are volume-sized scratch.
inline const int* nms_candidates(const float* peak, float thr,
                                 const int* radius, float* f0, float* f1,
                                 int* cidx, int* i0, int* i1, int D, int H,
                                 int W, cudaStream_t stream,
                                 cudaError_t* err) {
  const float* mx = maxpool3<float>(peak, f0, f1, radius, D, H, W, stream, err);
  if (*err != cudaSuccess) return nullptr;
  candidate_index_kernel<<<volume_grid(D, H, W), kThreads, 0, stream>>>(
      peak, mx, cidx, thr, D, H, W);
  *err = cudaGetLastError();
  if (*err != cudaSuccess) return nullptr;
  return maxpool3<int>(cidx, i0, i1, radius, D, H, W, stream, err);
}

}  // namespace
}  // namespace tpuseg
