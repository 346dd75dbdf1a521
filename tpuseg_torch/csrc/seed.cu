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
//   v     = h0 lockstep chase steps (the K2 walk kernel: one launch)
//
// The candidate steps (mx, cidx, midx) are nms.cuh's, shared with the
// peak-NMS kernel (nms.cu).
//
// Bound: memory. Each pooling launch reads 4 bytes per voxel (the 2r window
// along the axis comes from cache) and writes 4; the seed/dirs launch reads
// peak and fg at 7 points (mostly cached) plus cidx/midx and writes 8. About
// 14 whole-volume passes of ~8 bytes per voxel plus one chase walk of ~12:
// at least ~1 ms over 96x512x512 at 3.35 TB/s, against 0.12 ms for the bytes
// the function must move. The pooling chain is what is left to fuse.
#include "nms.cuh"

namespace tpuseg {
namespace {

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

}  // namespace
}  // namespace tpuseg

using namespace tpuseg;

// (dirs, v) of pallas_seed.seed_chase_pass. Scratch: f0, f1 (float, volume
// sized) and cidx, i0, i1 (int, volume sized). The result v lands in v_out.
extern "C" int tpuseg_seed_chase(const float* peak, const float* fgp,
                                 float peak_thr, float fg_thr, int rz, int ry,
                                 int rx, int h0, int D, int H, int W,
                                 float* f0, float* f1, int* cidx, int* i0,
                                 int* i1, int* dirs, int* v_out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = volume_grid(D, H, W);
  const int radius[3] = {rz, ry, rx};
  cudaError_t err;

  const int* midx = nms_candidates(peak, peak_thr, radius, f0, f1, cidx, i0, i1,
                                   D, H, W, s, &err);
  if (err != cudaSuccess) return err;

  // the pooled peak map in f0/f1 is dead once cidx exists: f0 holds v0
  int* v0 = reinterpret_cast<int*>(f0);
  seed_dirs_kernel<<<grid, kThreads, 0, s>>>(peak, fgp, cidx, midx, dirs, v0,
                                             fg_thr, D, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return run_chase(v0, dirs, v_out, nullptr, nullptr, h0, D, H, W, s);
}
