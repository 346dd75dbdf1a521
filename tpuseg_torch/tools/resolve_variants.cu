// Variants of the watershed resolve kernels (K2 chase, K3 flood) that were
// measured against the committed ones and lost or tied; built and timed by
// tools/resolve_variants.py, used nowhere in the package.
//
// flood: csrc/flood.cuh's kernel at other steps per launch and tiles (the
// committed choice is among them, for a side-by-side time).
// chase: the walk over a window of `dirs` staged in shared memory as bytes
// (core 8 x 16 x 64 with a halo of 8 on every axis), reading only the value
// it reaches from global memory, against the walk through L1/L2 (K1's,
// one thread a voxel); that walk with other thread blocks; and the
// package's chase pass (blocks walking their tile down z) at other z chunks,
// a pass that runs, an idle one and the gated loop of 128.
#include "flood.cuh"

namespace tpuseg {
namespace {

template <int HMAX, int TY, int TX, int NT>
cudaError_t flood_pass_variant(const float* pot, const int* l_in, int* l_out,
                               int* l_tmp, int* changed, int iters, int D,
                               int H, int W, cudaStream_t s) {
  const int launches = (iters + HMAX - 1) / HMAX;
  const int* src = l_in;
  for (int k = 0; k < launches; ++k) {
    int* dst = ((launches - 1 - k) % 2 == 0) ? l_out : l_tmp;
    const cudaError_t err = launch_flood<HMAX, TY, TX, NT>(
        pot, src, dst, changed, min(HMAX, iters - k * HMAX), D, H, W, s);
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

constexpr int kStageHalo = 8, kCZ = 8, kCY = 16, kCX = 64, kStageThreads = 512;
constexpr int kWZ = kCZ + 2 * kStageHalo, kWY = kCY + 2 * kStageHalo,
              kWX = kCX + 2 * kStageHalo;
constexpr unsigned char kOutside = 7;

// The hop walk over a staged window: codes as bytes, 7 outside the volume.
// iters <= kStageHalo.
__global__ void __launch_bounds__(kStageThreads)
chase_staged_kernel(const int* __restrict__ in, const int* __restrict__ dirs,
                    int* __restrict__ out,
                    const unsigned char* __restrict__ fg,
                    int* __restrict__ count, int iters, int D, int H, int W) {
  extern __shared__ unsigned char s_d[];
  const int tid = threadIdx.x;
  const int z0 = blockIdx.z * kCZ - kStageHalo;
  const int y0 = blockIdx.y * kCY - kStageHalo;
  const int x0 = blockIdx.x * kCX - kStageHalo;
  for (int p = tid; p < kWZ * kWY * kWX; p += kStageThreads) {
    const int wz = p / (kWY * kWX);
    const int r = p - wz * (kWY * kWX);
    const int wy = r / kWX;
    const int gz = z0 + wz, gy = y0 + wy, gx = x0 + r - wy * kWX;
    unsigned char code = kOutside;
    if (gz >= 0 && gz < D && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int d = __ldg(dirs + (gz * H + gy) * W + gx);
      code = (d >= 1 && d <= 6) ? d : 0;
    }
    s_d[p] = code;
  }
  __syncthreads();
  int zeros = 0;
  for (int q = tid; q < kCZ * kCY * kCX; q += kStageThreads) {
    const int cz = q / (kCY * kCX);
    const int r = q - cz * (kCY * kCX);
    const int cy = r / kCX;
    int wz = cz + kStageHalo, wy = cy + kStageHalo,
        wx = r - cy * kCX + kStageHalo;
    const int gz = z0 + wz, gy = y0 + wy, gx = x0 + wx;
    if (gz >= D || gy >= H || gx >= W) continue;
    for (int k = 0; k < iters; ++k) {
      const int d = s_d[(wz * kWY + wy) * kWX + wx];
      if (d == 0 || d == kOutside) break;
      wz += (d == 1) - (d == 2);
      wy += (d == 3) - (d == 4);
      wx += (d == 5) - (d == 6);
    }
    const bool outside = s_d[(wz * kWY + wy) * kWX + wx] == kOutside;
    const int val =
        outside ? 0 : __ldg(in + ((z0 + wz) * H + y0 + wy) * W + x0 + wx);
    const int i = (gz * H + gy) * W + gx;
    out[i] = val;
    zeros += fg[i] && val == 0;
  }
  zeros = __reduce_add_sync(0xffffffffu, zeros);
  if ((tid & 31) == 0 && zeros > 0) atomicAdd(count, zeros);
}

}  // namespace
}  // namespace tpuseg

using namespace tpuseg;

// variant 0: the committed walk; 1: the staged window (iters <= 8); 2..: the
// walk with other block shapes (x, y, z).
extern "C" int variant_chase_pass(int variant, const int* v_in,
                                  const int* dirs, const unsigned char* fg,
                                  int* v_out, int* count, int iters, int D,
                                  int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  if (variant == 0)
    return run_chase(v_in, dirs, v_out, fg, count, iters, D, H, W, s);
  if (variant >= 2) {
    const dim3 blocks[] = {dim3(128, 1, 1), dim3(32, 8, 1), dim3(32, 4, 4),
                           dim3(32, 8, 4), dim3(64, 4, 4), dim3(256, 1, 1),
                           dim3(16, 8, 8)};
    if (variant - 2 >= static_cast<int>(sizeof(blocks) / sizeof(blocks[0])))
      return cudaErrorInvalidValue;
    return run_chase(v_in, dirs, v_out, fg, count, iters, D, H, W, s,
                     blocks[variant - 2]);
  }
  if (iters > kStageHalo) return cudaErrorInvalidValue;
  const int smem = kWZ * kWY * kWX;
  err = cudaFuncSetAttribute(chase_staged_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kCX - 1) / kCX, (H + kCY - 1) / kCY,
                  (D + kCZ - 1) / kCZ);
  chase_staged_kernel<<<grid, kStageThreads, smem, s>>>(v_in, dirs, v_out, fg,
                                                        count, iters, D, H, W);
  return cudaGetLastError();
}

// The package's chase pass (common.cuh: chase_pass_kernel) walking `zchunk`
// planes a block; with `gate` set (to a zero in device memory) the pass is
// idle and copies nothing.
extern "C" int variant_chase_zchunk(int zchunk, const int* v_in,
                                    const int* dirs, const unsigned char* fg,
                                    int* v_out, int* count, const int* gate,
                                    int iters, int D, int H, int W,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  return launch_chase_pass(v_in, dirs, v_out, fg, count, gate, gate, iters,
                           D, H, W, s, zchunk);
}

// The package's gated chase loop (resolve.cu: tpuseg_chase_resolve) with
// its passes walking `zchunk` planes a block.
extern "C" int variant_chase_resolve_zchunk(int zchunk, const int* v_in,
                                            const int* dirs,
                                            const unsigned char* fg, int* b1,
                                            int* b2, int* flags, int iters,
                                            int max_passes, int D, int H,
                                            int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int k = 1; k <= max_passes; ++k) {
    const int* src = k == 1 ? v_in : (k % 2 == 0 ? b1 : b2);
    int* dst = k % 2 == 1 ? b1 : b2;
    const cudaError_t err = launch_chase_pass(
        src, dirs, dst, fg, flags + k, flags + k - 1,
        k <= 2 ? nullptr : flags + k - 2, iters, D, H, W, s, zchunk);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Steps per launch x tile (threads) by variant.
extern "C" int variant_flood_pass(int variant, const float* pot,
                                  const int* l_in, int* l_out, int* l_tmp,
                                  int* changed, int iters, int D, int H,
                                  int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  switch (variant) {
    case 0: return flood_pass_variant<4, 16, 64, 448>(
        pot, l_in, l_out, l_tmp, changed, iters, D, H, W, s);
    case 1: return flood_pass_variant<8, 16, 64, 640>(
        pot, l_in, l_out, l_tmp, changed, iters, D, H, W, s);
    case 2: return flood_pass_variant<8, 8, 64, 480>(
        pot, l_in, l_out, l_tmp, changed, iters, D, H, W, s);
    case 3: return flood_pass_variant<4, 32, 64, 736>(
        pot, l_in, l_out, l_tmp, changed, iters, D, H, W, s);
    case 4: return flood_pass_variant<4, 8, 64, 288>(
        pot, l_in, l_out, l_tmp, changed, iters, D, H, W, s);
    case 5: return flood_pass_variant<2, 16, 64, 384>(
        pot, l_in, l_out, l_tmp, changed, iters, D, H, W, s);
    case 6: return flood_pass_variant<4, 16, 32, 256>(
        pot, l_in, l_out, l_tmp, changed, iters, D, H, W, s);
    case 7: return flood_pass_variant<4, 16, 128, 832>(
        pot, l_in, l_out, l_tmp, changed, iters, D, H, W, s);
    case 8: return flood_pass_variant<4, 32, 32, 416>(
        pot, l_in, l_out, l_tmp, changed, iters, D, H, W, s);
    case 9: return flood_pass_variant<4, 32, 16, 256>(
        pot, l_in, l_out, l_tmp, changed, iters, D, H, W, s);
    case 10: return flood_pass_variant<4, 24, 24, 256>(
        pot, l_in, l_out, l_tmp, changed, iters, D, H, W, s);
    case 11: return flood_pass_variant<4, 32, 24, 320>(
        pot, l_in, l_out, l_tmp, changed, iters, D, H, W, s);
    case 12: return flood_pass_variant<4, 24, 32, 320>(
        pot, l_in, l_out, l_tmp, changed, iters, D, H, W, s);
    case 13: return flood_pass_variant<4, 48, 32, 576>(
        pot, l_in, l_out, l_tmp, changed, iters, D, H, W, s);
    case 14: return flood_pass_variant<8, 32, 32, 576>(
        pot, l_in, l_out, l_tmp, changed, iters, D, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}
