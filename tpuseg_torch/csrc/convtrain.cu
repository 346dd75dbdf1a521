// K6: the training path's bias-free 3x3x3 SAME convolution on the H100.
//
// Replaces tpuseg/ops/pallas_convtrain.py:flat_conv3x3 (_conv_kernel), which
// the conv3x3_p2 custom_vjp runs for the forward and, with flip_w weights and
// ci/co swapped, for dx. Here the same entry points serve both: the Python
// wrapper (ops/convtrain.py) hands them the flipped, transposed weights for
// dx.
//
//   y[n, o, z, y, x] = sum_{c, kd, kh, kw} w[c, (kd*3 + kh)*3 + kw, o]
//                      * x[n, c, z + kd - 1, y + kh - 1, x + kw - 1]
//
// NCDHW tensors in bf16 or f32, any N, D, H, W; out-of-volume taps read
// zero (masked here, no padded copy). Products are accumulated in f32 and
// rounded once to the output type, as the TPU kernel does.
//
// What bounds it: operations. At the training shape (8 x 32 x 64^3, co = 32)
// a conv is 58 G multiply-adds against ~270 MB of bf16 in + out. Two bodies;
// the wrapper picks one by (dtype, ci, co), never by a failure:
//
// * conv3x3_mma_kernel (bf16; ci 16, 32 or 64; co 32 or 64; not 64 -> 64):
//   the implicit GEMM of conv_mma.cuh on the tensor cores. A CTA owns an
//   8-row x TX-column (y, x) tile (TX = 16 or 32) and marches over a chunk of
//   16 z planes. The packed weights (27 * ci * co bf16, 55 or 110 KB) are
//   copied into shared memory once and stay; the input halo (10 x (TX + 2)
//   positions, all channels, interleaved 8 channels to a 16-byte word) lives
//   in a ring of 4 plane slots, so each input plane is staged once per CTA.
//   Per output plane a warpgroup starts 27 * ci/16 asynchronous wgmma for
//   each of its 64-row tiles (8 rows x 8 columns: the descriptor's M stride
//   is the halo's row pitch), then stores plane z + 2 into the ring (its
//   loads were started a step earlier and waited in registers), starts the
//   loads of plane z + 3, waits for the products and stores its
//   accumulators. One warpgroup with two tiles and two CTAs an SM at 55 KB of
//   weights; two warpgroups and one CTA at 110 KB. The feed from shared
//   memory (24 clocks an m64n32k16 against 16 on the tensor cores) is the
//   next ceiling; the stores are 2 bytes each, 16 contiguous bytes a channel.
// * conv3x3_kernel (f32, whose contract is exact f32 products, and ci = 1 or
//   other channel counts): the CUDA cores' f32 FMA pipes. One CTA computes
//   an 8-row x 32-column tile of one z plane for 32 output channels; each
//   thread owns one x column, 4 rows and 8 channels, i.e. 32 f32
//   accumulators; the input halo (3 planes x 10 rows x 34 columns) and the
//   weights of 4 input channels at a time are staged in shared memory
//   (30 KB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv_mma.cuh"

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


// ---- the tensor-core body -------------------------------------------------

constexpr int kMmaTileY = 8;                 // output rows per CTA
constexpr int kMmaHaloY = kMmaTileY + 2;
constexpr int kMmaSlots = 4;                 // ring of staged input planes
constexpr int kMmaZChunk = 16;               // output planes per CTA

// Shared memory: [27][ci/8][CO][8] weights, then the ring
// [slot][ci/8][kMmaHaloY * (TX + 2)] of 16-byte words.
template <int CO, int KSTEPS, int MT, int NWG>
__global__ void __launch_bounds__(mma::kWarpgroup * NWG)
conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ wp,
                   __nv_bfloat16* __restrict__ y, int D, int H, int W,
                   int tiles_x) {
  constexpr int ci = 16 * KSTEPS;
  constexpr int kThreadsMma = mma::kWarpgroup * NWG;
  constexpr int kTX = 8 * MT * NWG;          // output columns per CTA
  constexpr int kHX = kTX + 2;
  constexpr int kWindow = kMmaHaloY * kHX;   // positions of one halo plane
  extern __shared__ __align__(128) unsigned char smem_raw[];

  constexpr int groups = ci / 8;
  constexpr int w_words = 27 * ci * CO / 8;
  uint4* ws = reinterpret_cast<uint4*>(smem_raw);
  uint4* ring = ws + w_words;
  constexpr int slot_words = groups * kWindow;

  const int tx0 = (blockIdx.x % tiles_x) * kTX;
  const int ty0 = (blockIdx.x / tiles_x) * kMmaTileY;
  const int z0 = blockIdx.y * kMmaZChunk;
  const int z1 = min(z0 + kMmaZChunk, D);
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;           // within the warpgroup
  const int wg = tid / mma::kWarpgroup;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const __nv_bfloat16* xn = x + static_cast<int64_t>(n) * ci * D * plane;
  __nv_bfloat16* yn = y + static_cast<int64_t>(n) * CO * D * plane;

  // Plane gz lives in ring slot gz mod kMmaSlots. Where the tensor allows
  // vector loads, a plane's loads are started one step before its store and
  // stay in flight in registers over that step's products and epilogue.
  using Stage = mma::VecStage<kThreadsMma, kMmaHaloY, kHX>;
  static_assert(Stage::max_units(groups) <= Stage::kBatch * kThreadsMma,
                "a plane is at most kBatch units a thread");
  Stage regs;
  const bool vec = mma::vec_ok(xn, W);
  auto slot_of = [&](int gz) {
    return ring + ((gz + kMmaSlots) % kMmaSlots) * slot_words;
  };
  auto load_plane = [&](int gz) {
    if (vec && gz <= z1)
      regs.load(xn, 0, groups, gz, ty0 - 1, tx0 - 1, D, H, W, tid);
  };
  auto store_plane = [&](int gz) {
    if (gz > z1) return;
    if (vec)
      regs.store(slot_of(gz), kWindow, groups, tx0 - 1, tid);
    else
      mma::stage_plane_scalar<kThreadsMma, kMmaHaloY, kHX>(
          slot_of(gz), kWindow, xn, 0, groups, gz, ty0 - 1, tx0 - 1, D, H, W,
          tid);
  };

  mma::copy_words<kThreadsMma>(ws, wp, w_words);
  for (int gz = z0 - 1; gz <= z0 + 1; ++gz) {
    load_plane(gz);
    store_plane(gz);
  }
  load_plane(z0 + 2);
  mma::proxy_fence();
  __syncthreads();

  const uint32_t ws_addr = mma::smem_addr(ws);
  const uint32_t ring_addr = mma::smem_addr(ring);
  const uint32_t tile_off = wg * MT * 8 * mma::kWord;  // this warpgroup's x

  for (int z = z0; z < z1; ++z) {
    float acc[MT][CO / 2];
#pragma unroll
    for (int t = 0; t < MT; ++t) {
#pragma unroll
      for (int i = 0; i < CO / 2; ++i) acc[t][i] = 0.f;
      mma::fence_acc(acc[t]);
    }
    mma::fence();
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
      const int slot = (z - 1 + kd + kMmaSlots) % kMmaSlots;
      mma::mma_plane<CO, MT, KSTEPS>(
          acc, ring_addr + slot * slot_words * mma::kWord + tile_off,
          8 * mma::kWord, kHX * mma::kWord, kWindow * mma::kWord,
          kHX * mma::kWord, ws_addr + kd * 9 * ci * CO * 2, ci * CO * 2);
    }
    mma::commit();
    // plane z + 2 goes into the slot of plane z - 2 while the products run,
    // and the loads of plane z + 3 start
    store_plane(z + 2);
    load_plane(z + 3);
    mma::wait_all();
#pragma unroll
    for (int t = 0; t < MT; ++t) mma::fence_acc(acc[t]);

    __nv_bfloat16* out = yn + static_cast<int64_t>(z) * plane;
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const int gx = tx0 + (wg * MT + t) * 8 + (lane >> 2);
#pragma unroll
      for (int i = 0; i < CO / 2; ++i) {
        const int gy = ty0 + 2 * warp + ((i >> 1) & 1);
        const int ch = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (gx < W && gy < H)
          out[static_cast<int64_t>(ch) * D * plane +
              static_cast<int64_t>(gy) * W + gx] = __float2bfloat16(acc[t][i]);
      }
    }
    mma::proxy_fence();
    __syncthreads();
  }
}

template <int CO, int KSTEPS, int MT, int NWG>
int launch_mma(const void* x, const void* wp, void* y, int N, int D, int H,
               int W, void* stream) {
  constexpr int ci = 16 * KSTEPS;
  constexpr int kTX = 8 * MT * NWG;
  constexpr int smem =
      27 * ci * CO * 2 +
      kMmaSlots * (ci / 8) * kMmaHaloY * (kTX + 2) * mma::kWord;
  static_assert(smem <= mma::kMaxSmem, "weights and ring exceed a block");
  auto kernel = conv3x3_mma_kernel<CO, KSTEPS, MT, NWG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + kTX - 1) / kTX;
  const int tiles_y = (H + kMmaTileY - 1) / kMmaTileY;
  const dim3 grid(tiles_x * tiles_y, (D + kMmaZChunk - 1) / kMmaZChunk, N);
  kernel<<<grid, mma::kWarpgroup * NWG, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp), static_cast<__nv_bfloat16*>(y),
      D, H, W, tiles_x);
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

// The same function on the tensor cores, bf16 only. x, y as above; wp: the
// weights packed as [27][ci / 8][co][8] bf16 (ops/conv_mma.py). ci must be
// 16, 32 or 64 and co 32 or 64, with ci * co <= 2048 (the weights, 27 * ci *
// co * 2 bytes, and the input ring lie in one block's shared memory); the
// wrapper checks ceil(D/16), N <= 65535.
extern "C" int tpuseg_conv3x3_mma(const void* x, const void* wp, void* y,
                                  int N, int ci, int co, int D, int H, int W,
                                  void* stream) {
  using tpuseg::launch_mma;
  // co = 32: one warpgroup with two 64-row tiles, two CTAs an SM; at 64 input
  // channels the weights leave room for one CTA: two warpgroups, a tile each
  if (co == 32 && ci == 16)
    return launch_mma<32, 1, 2, 1>(x, wp, y, N, D, H, W, stream);
  if (co == 32 && ci == 32)
    return launch_mma<32, 2, 2, 1>(x, wp, y, N, D, H, W, stream);
  if (co == 32 && ci == 64)
    return launch_mma<32, 4, 1, 2>(x, wp, y, N, D, H, W, stream);
  if (co == 64 && ci == 16)
    return launch_mma<64, 1, 2, 2>(x, wp, y, N, D, H, W, stream);
  if (co == 64 && ci == 32)
    return launch_mma<64, 2, 2, 2>(x, wp, y, N, D, H, W, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
