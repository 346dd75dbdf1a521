// K6: the training path's bias-free 3x3x3 SAME convolution on the H100.
//
// Replaces tpuseg/ops/pallas_convtrain.py:flat_conv3x3 (_conv_kernel), which
// the conv3x3_p2 custom_vjp runs for the forward and, with flip_w weights and
// ci/co swapped, for dx. Here the same entry point serves both: the Python
// wrapper (ops/convtrain.py) hands it the flipped, transposed weights for dx.
//
//   y[n, o, z, y, x] = sum_{c, kd, kh, kw} w[c, (kd*3 + kh)*3 + kw, o]
//                      * x[n, c, z + kd - 1, y + kh - 1, x + kw - 1]
//
// NCDHW tensors in bf16 or f32, any N, C, D, H, W; out-of-volume taps read
// zero (masked here, no padded copy). Products are accumulated in f32 and
// rounded once to the output type, as the TPU kernel does.
//
// What bounds it: at the training shape (8 x 32 x 64^3, co = 32) a conv is
// 58 G multiply-adds against ~270 MB of bf16 in + out, so it is compute
// bound; this first version runs on the CUDA cores' f32 FMA pipes (~30 T FMA/s
// peak on the H100), not the tensor cores. The design keeps the FMA pipes
// fed from registers and shared memory:
//
// * one CTA computes an 8-row x 32-column tile of one z plane for 32 output
//   channels; each thread owns one x column, 4 rows and 8 channels, i.e. 32
//   f32 accumulators in registers;
// * the input halo (3 planes x 10 rows x 34 columns) and the weights of 4
//   input channels at a time are staged in shared memory (30 KB), so each
//   input value loaded from device memory feeds 27 taps x 32 channels;
// * per (channel, plane) a thread reads 18 input values (neighbouring lanes
//   on neighbouring words: no bank conflicts) and 18 float4 weight vectors
//   (one address per warp: broadcast) for 288 FMAs.
//
// A tensor-core implicit GEMM (wgmma fed by TMA) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tpuseg {
namespace {

constexpr int kTileX = 32;                    // output columns per CTA (lanes)
constexpr int kRowsPerThread = 4;
constexpr int kRowGroups = 2;
constexpr int kTileY = kRowsPerThread * kRowGroups;   // 8 output rows per CTA
constexpr int kChanPerThread = 8;
constexpr int kChanGroups = 4;
constexpr int kTileCo = kChanPerThread * kChanGroups;  // 32 output channels
constexpr int kChunk = 4;                     // input channels per smem round
constexpr int kThreads = 32 * kRowGroups * kChanGroups;  // 256
constexpr int kHaloX = kTileX + 2;
constexpr int kHaloY = kTileY + 2;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ wk,
               T* __restrict__ y, int ci, int co, int D, int H, int W,
               int tiles_x, int co_blocks) {
  __shared__ float xs[kChunk][3][kHaloY][kHaloX];
  __shared__ __align__(16) float ws[kChunk][27][kTileCo];

  const int tx0 = (blockIdx.x % tiles_x) * kTileX;
  const int ty0 = (blockIdx.x / tiles_x) * kTileY;
  const int z = blockIdx.y;
  const int n = blockIdx.z / co_blocks;
  const int o0 = (blockIdx.z % co_blocks) * kTileCo;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = warp % kRowGroups;           // warp-uniform row group
  const int cg = warp / kRowGroups;           // warp-uniform channel group
  const int64_t plane = static_cast<int64_t>(H) * W;

  float acc[kRowsPerThread][kChanPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
    for (int o = 0; o < kChanPerThread; ++o) acc[j][o] = 0.f;

  for (int c0 = 0; c0 < ci; c0 += kChunk) {
    __syncthreads();  // the previous round's reads are done
    for (int i = threadIdx.x; i < kChunk * 3 * kHaloY * kHaloX;
         i += kThreads) {
      const int col = i % kHaloX;
      int t = i / kHaloX;
      const int row = t % kHaloY;
      t /= kHaloY;
      const int kz = t % 3;
      const int c = t / 3;
      const int gx = tx0 - 1 + col;
      const int gy = ty0 - 1 + row;
      const int gz = z - 1 + kz;
      const int gc = c0 + c;
      float v = 0.f;
      if (gc < ci && gz >= 0 && gz < D && gy >= 0 && gy < H && gx >= 0 &&
          gx < W) {
        v = load_f32(x + ((static_cast<int64_t>(n) * ci + gc) * D + gz) *
                             plane +
                     static_cast<int64_t>(gy) * W + gx);
      }
      xs[c][kz][row][col] = v;
    }
    for (int i = threadIdx.x; i < kChunk * 27 * kTileCo; i += kThreads) {
      const int o = i % kTileCo;
      const int t = i / kTileCo;
      const int tap = t % 27;
      const int c = t / 27;
      const int gc = c0 + c;
      const int go = o0 + o;
      ws[c][tap][o] = (gc < ci && go < co)
                          ? __ldg(wk + (static_cast<int64_t>(gc) * 27 + tap) *
                                           co + go)
                          : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < kChunk; ++c) {
#pragma unroll
      for (int kz = 0; kz < 3; ++kz) {
        float in[kRowsPerThread + 2][3];
#pragma unroll
        for (int r = 0; r < kRowsPerThread + 2; ++r)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            in[r][dx] = xs[c][kz][rg * kRowsPerThread + r][lane + dx];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float* wp = &ws[c][(kz * 3 + ky) * 3 + kx][cg * kChanPerThread];
            const float4 wa = *reinterpret_cast<const float4*>(wp);
            const float4 wb = *reinterpret_cast<const float4*>(wp + 4);
            const float wv[kChanPerThread] = {wa.x, wa.y, wa.z, wa.w,
                                              wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int j = 0; j < kRowsPerThread; ++j) {
              const float v = in[j + ky][kx];
#pragma unroll
              for (int o = 0; o < kChanPerThread; ++o)
                acc[j][o] = fmaf(v, wv[o], acc[j][o]);
            }
          }
        }
      }
    }
  }

  const int gx = tx0 + lane;
  if (gx >= W) return;
#pragma unroll
  for (int o = 0; o < kChanPerThread; ++o) {
    const int go = o0 + cg * kChanPerThread + o;
    if (go >= co) continue;
    T* out = y + (static_cast<int64_t>(n) * co + go) * D * plane +
             static_cast<int64_t>(z) * plane;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int gy = ty0 + rg * kRowsPerThread + j;
      if (gy < H) store(out + static_cast<int64_t>(gy) * W + gx, acc[j][o]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* wk, void* y, int N, int ci, int co,
           int D, int H, int W, void* stream) {
  const int tiles_x = (W + kTileX - 1) / kTileX;
  const int tiles_y = (H + kTileY - 1) / kTileY;
  const int co_blocks = (co + kTileCo - 1) / kTileCo;
  const dim3 grid(tiles_x * tiles_y, D, N * co_blocks);
  conv3x3_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), wk, static_cast<T*>(y), ci, co, D, H, W,
      tiles_x, co_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tpuseg

// y = conv3x3x3_SAME(x, w) without bias. x: (N, ci, D, H, W), y: (N, co, D,
// H, W), both bf16 (bf16 = 1) or f32 (bf16 = 0), contiguous; wk: (ci, 27, co)
// f32, tap = (kd*3 + kh)*3 + kw. The wrapper checks D, N*ceil(co/32) <= 65535.
extern "C" int tpuseg_conv3x3(const void* x, const float* wk, void* y, int N,
                              int ci, int co, int D, int H, int W, int bf16,
                              void* stream) {
  return bf16 ? tpuseg::launch<__nv_bfloat16>(x, wk, y, N, ci, co, D, H, W,
                                              stream)
              : tpuseg::launch<float>(x, wk, y, N, ci, co, D, H, W, stream);
}
