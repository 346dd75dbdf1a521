// K1: watershed seeding on the H100.
//
// Replaces tpuseg/ops/pallas_seed.py:seed_chase_pass (_seed_kernel). Same
// result, as a chain of whole-volume launches instead of one VMEM window:
//
//   mx    = (2r+1)^3 max-pool of peak, -inf outside   (3 separable launches)
//   cidx  = lin where peak >= thr and peak >= mx, else -1
//   midx  = (2r+1)^3 max-pool of cidx, -1 outside     (3 separable launches)
//   seeds = cidx >= 0 & cidx == midx & fg,  fg = fg_prob >= fg_thr
//   dirs  = steepest ascent over (peak on fg, lin), 0 at seeds and off fg
//   v0    = +(lin+1) at seeded roots, -(lin+1) at unseeded roots, 0 elsewhere
//   v     = h0 lockstep chase steps (the K2 step kernel)
//
// The index pool runs on int32: linear indices of the 96x512x512 stack pass
// 2^24, where a float32 pool would merge neighbouring candidates.
//
// Bound: memory. Each pooling launch reads 4 bytes per voxel (the 2r window
// along the axis comes from cache) and writes 4; the seed/dirs launch reads
// peak and fg at 7 points (mostly cached) plus cidx/midx and writes 8. About
// 14 whole-volume passes of ~8 bytes per voxel plus h0 chase steps: at least
// ~1-2 ms over 96x512x512 at 3.35 TB/s. Fusing it into one shared-memory tile
// pass, as the TPU kernel does in VMEM, is later work.
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

// Seeds, steepest-ascent direction codes and the signed root payload v0.
__global__ void seed_dirs_kernel(const float* __restrict__ peak,
                                 const float* __restrict__ fgp,
                                 const int* __restrict__ cidx,
                                 const int* __restrict__ midx,
                                 int* __restrict__ dirs, int* __restrict__ v0,
                                 float fg_thr, int D, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const int y = blockIdx.y;
  const int z = blockIdx.z;
  const int i = (z * H + y) * W + x;
  const bool fg = fgp[i] >= fg_thr;
  const int ci = cidx[i];
  const bool seed = fg && ci >= 0 && ci == midx[i];
  int code = 0;
  if (fg && !seed) {
    // argmax over {self} U 6 neighbours of (potential, lin), potential
    // -inf off the foreground — watershed.steepest_dir_codes
    float best_pot = peak[i];
    int best_idx = i;
    for (int c = 1; c <= 6; ++c) {
      const int j = neighbor(c, i, z, y, x, D, H, W);
      if (j < 0) continue;
      const float np = fgp[j] >= fg_thr ? peak[j] : -CUDART_INF_F;
      if (np > best_pot || (np == best_pot && j > best_idx)) {
        best_pot = np;
        best_idx = j;
        code = c;
      }
    }
  }
  dirs[i] = code;
  v0[i] = (fg && code == 0) ? (seed ? i + 1 : -(i + 1)) : 0;
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

}  // namespace
}  // namespace tpuseg

using namespace tpuseg;

// (dirs, v) of pallas_seed.seed_chase_pass. Scratch: f0, f1 (float, volume
// sized) and cidx, i0, i1, v_tmp (int, volume sized). The result v lands in
// v_out.
extern "C" int tpuseg_seed_chase(const float* peak, const float* fgp,
                                 float peak_thr, float fg_thr, int rz, int ry,
                                 int rx, int h0, int D, int H, int W,
                                 float* f0, float* f1, int* cidx, int* i0,
                                 int* i1, int* dirs, int* v_out, int* v_tmp,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = volume_grid(D, H, W);
  const int radius[3] = {rz, ry, rx};
  cudaError_t err;

  const float* mx = maxpool3<float>(peak, f0, f1, radius, D, H, W, s, &err);
  if (err != cudaSuccess) return err;
  candidate_index_kernel<<<grid, kThreads, 0, s>>>(peak, mx, cidx, peak_thr,
                                                   D, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int* midx = maxpool3<int>(cidx, i0, i1, radius, D, H, W, s, &err);
  if (err != cudaSuccess) return err;

  // v0 goes where the first chase step does not write (see pingpong_dst)
  int* v0 = (h0 % 2 == 1) ? v_tmp : v_out;
  seed_dirs_kernel<<<grid, kThreads, 0, s>>>(peak, fgp, cidx, midx, dirs, v0,
                                             fg_thr, D, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return run_chase(v0, dirs, v_out, v_tmp, nullptr, nullptr, h0, D, H, W, s);
}
