// K4: the fused full-resolution eval ConvBlock on the H100.
//
// Replaces tpuseg/ops/pallas_convblock.py:fused_convblock_chw (_kernel):
//
//   out = relu(aff2(conv2(T))),   T = relu(aff1(conv1(x)))
//
// for 3x3x3 SAME convolutions with 32 output channels, aff(v) = v * s + b per
// channel (BatchNorm's running statistics folded), on NCDHW tensors in bf16
// or f32, any N, ci, D, H, W. Products are accumulated in f32, the affine and
// the ReLU run in f32, and there is one rounding to the storage type at T and
// one at the output, as in the TPU kernel. T never reaches device memory.
// conv2's SAME padding pads T, so T is ZERO outside the volume (not
// relu(b1), which conv1 of zero-padded x would give there): the T epilogue
// masks rows, columns and planes outside [0, H) x [0, W) x [0, D).
//
// Both bodies march a CTA over a chunk of 16 z planes with a 3-plane ring of
// T in shared memory, which is what the TPU kernel does along z: at step j
// the CTA computes T plane j on its tile plus a 1-voxel rim and then output
// plane j - 1 from T planes j - 2 .. j; nothing is recomputed along z but the
// two planes at a chunk's ends. What bounds both: operations (a
// (1, 64, 64, 160, 160) block is 136 G multiply-adds against ~0.3 GB of bf16
// in and out). The wrapper picks the body by the storage type.
//
// convblock_mma_kernel (bf16): the implicit GEMM of conv_mma.cuh on the
// tensor cores, an 8-row x 14-column output tile a CTA.
// * conv2 (32 -> 32) reads T straight from the ring, kept in the interleaved
//   layout [4 groups][10 rows x 16 columns][8 channels]: an output plane is
//   8 x 16 = 128 consecutive positions of the flattened T plane shifted by
//   kh * 16 + kw, i.e. two 64-row tiles whose descriptor M stride is 128
//   bytes; the two columns that wrap into the next row are not stored.
// * conv1 for ci = 32 or 64 runs the same way over a staged x window of
//   12 rows x 18 columns: the 10 x 16 T positions lie within 3 tiles of 64
//   flattened positions of pitch 18. Its epilogue applies aff1 + ReLU in
//   f32, zeroes T outside the volume, rounds to bf16 and writes the ring:
//   an accumulator pair is two neighbouring channels of one position.
//   For other ci (enc0's ci = 1: a 27-deep product) conv1 runs on the CUDA
//   cores, 27 FMAs a channel, and writes T in the same layout, so conv2 is
//   one code path.
// * Shared memory at ci = 64 (226,944 of 232,448 bytes, one CTA an SM): both
//   weight sets resident, packed for wgmma (110,592 + 55,296); the T ring
//   3 x 4 x 162 words of 16 bytes (31,104); the affines (512); and, because
//   an x ring of 64 channels does not fit beside them, conv1's input
//   streamed in pieces of (one z plane, 32 channels) through a double buffer
//   of 2 x 4 x 230 words (29,440). So an x plane is staged three times (once
//   per T plane that reads it) instead of once; the tiles compute 192 conv1
//   and 128 conv2 positions for 112 outputs. At ci = 32 it is 171,648 bytes,
//   at ci = 1 89,504 (two CTAs an SM).
// * Two warpgroups where conv1 is on the tensor cores: the first starts the
//   wgmma and runs the epilogues; the second stages. While piece g is
//   multiplied it stores piece g + 1, whose loads it started a step earlier
//   and kept in flight in registers, and starts the loads of piece g + 2; a
//   CTA-wide barrier ends each piece. A warp that starts wgmma stalls while
//   the tensor cores' queue is full, so staging by the same warps does not
//   overlap with their own products.
// * What is left: the re-staging. At ci = 64 the window loads (three times
//   the input, 12 rows for 8, 64 bytes of sectors for 36 used) cost a large
//   share of the kernel's time though their latency is hidden: it is their
//   volume. One staging per x plane with three T planes' sums in registers
//   was tried and lost to register pressure (spills).
//
// convblock_kernel (f32, whose contract is exact f32 products): an 8-row x
// 30-column tile on the CUDA cores' f32 FMA pipes like the training conv's
// f32 body (convtrain.cu): a thread owns one column, 5 (conv1) or 4 (conv2)
// rows and 8 output channels; the weights of 4 input channels at a time
// (f32, 13.5 KB) and, for conv1, the input halo of those channels (3 planes
// x 12 x 34) are staged in shared memory; conv2 reads its input straight
// from the T ring (10 x 32 positions, one T column per lane). ci = 1 stages
// and multiplies one channel, not four.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv_mma.cuh"

namespace tpuseg {
namespace {

constexpr int kCo = 32;                      // output channels of both convs
constexpr int kLanes = 32;                   // T columns per CTA, one a lane
constexpr int kOutX = kLanes - 2;            // 30 output columns per CTA
constexpr int kOutY = 8;                     // output rows per CTA
constexpr int kTY = kOutY + 2;               // 10 T rows per CTA
constexpr int kRowGroups = 2;
constexpr int kRows1 = kTY / kRowGroups;     // T rows per thread (conv1)
constexpr int kRows2 = kOutY / kRowGroups;   // output rows per thread (conv2)
constexpr int kChanPerThread = 8;
constexpr int kChanGroups = kCo / kChanPerThread;        // 4
constexpr int kThreads = 32 * kRowGroups * kChanGroups;  // 256
constexpr int kChunk = 4;                    // input channels per smem round
constexpr int kXY = kTY + 2;                 // 12 staged input rows
constexpr int kXX = kLanes + 2;              // 34 staged input columns
constexpr int kZChunk = 16;                  // output planes per CTA

struct Smem {
  float ws[kChunk][27][kCo];        // weights of the staged input channels
  float xs[kChunk][3][kXY][kXX];    // conv1's input halo of those channels
  float t[3][kCo][kTY][kLanes];     // ring of T planes, slot = plane mod 3
};

// acc[j][o] += sum_{ky, kx} in[j + ky][kx] * w[(ky*3 + kx)][o] for the 8
// channels at `wplane` (the 9 taps of one kz, kCo floats apart).
template <int ROWS>
__device__ __forceinline__ void fma_rows(
    float (&acc)[ROWS][kChanPerThread], const float (&in)[ROWS + 2][3],
    const float* wplane) {
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const float* wp = wplane + (ky * 3 + kx) * kCo;
      const float4 wa = *reinterpret_cast<const float4*>(wp);
      const float4 wb = *reinterpret_cast<const float4*>(wp + 4);
      const float wv[kChanPerThread] = {wa.x, wa.y, wa.z, wa.w,
                                        wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const float v = in[j + ky][kx];
#pragma unroll
        for (int o = 0; o < kChanPerThread; ++o)
          acc[j][o] = fmaf(v, wv[o], acc[j][o]);
      }
    }
  }
}

// ws[c][tap][o] <- wk[c0 + c][tap][o] for c < nc; wk is (channels, 27, kCo).
__device__ __forceinline__ void stage_weights(float* ws, const float* wk,
                                              int c0, int nc) {
  const float* src = wk + static_cast<int64_t>(c0) * 27 * kCo;
  for (int i = threadIdx.x; i < nc * 27 * kCo; i += kThreads)
    ws[i] = __ldg(src + i);
}

__global__ void __launch_bounds__(kThreads)
convblock_kernel(const float* __restrict__ x, const float* __restrict__ w1k,
                 const float* __restrict__ s1, const float* __restrict__ b1,
                 const float* __restrict__ w2k, const float* __restrict__ s2,
                 const float* __restrict__ b2, float* __restrict__ y, int ci,
                 int D, int H, int W, int z_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tx0 = blockIdx.x * kOutX;       // first output column
  const int ty0 = blockIdx.y * kOutY;       // first output row
  const int n = blockIdx.z / z_chunks;
  const int z0 = (blockIdx.z % z_chunks) * kZChunk;
  const int z1 = min(z0 + kZChunk, D);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = warp % kRowGroups;         // warp-uniform row group
  const int cg = warp / kRowGroups;         // warp-uniform channel group
  const int ch0 = cg * kChanPerThread;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const float* xn = x + static_cast<int64_t>(n) * ci * D * plane;
  float* yn = y + static_cast<int64_t>(n) * kCo * D * plane;

  for (int j = z0 - 1; j <= z1; ++j) {
    // conv2 of the previous step has read the ring slot this step overwrites
    __syncthreads();
    float(*tp)[kTY][kLanes] = sm.t[(j + 3) % 3];

    if (j >= 0 && j < D) {
      // ---- T plane j = relu(aff1(conv1(x))) on rows ty0-1.., cols tx0-1..
      float acc[kRows1][kChanPerThread];
#pragma unroll
      for (int r = 0; r < kRows1; ++r)
#pragma unroll
        for (int o = 0; o < kChanPerThread; ++o) acc[r][o] = 0.f;

      for (int c0 = 0; c0 < ci; c0 += kChunk) {
        const int nc = min(kChunk, ci - c0);
        __syncthreads();  // the previous round's reads of ws, xs are done
        for (int i = threadIdx.x; i < nc * 3 * kXY * kXX; i += kThreads) {
          const int col = i % kXX;
          int t = i / kXX;
          const int row = t % kXY;
          t /= kXY;
          const int kz = t % 3;
          const int c = t / 3;
          const int gx = tx0 - 2 + col;
          const int gy = ty0 - 2 + row;
          const int gz = j - 1 + kz;
          float v = 0.f;
          if (gz >= 0 && gz < D && gy >= 0 && gy < H && gx >= 0 && gx < W) {
            v = __ldg(xn + (static_cast<int64_t>(c0 + c) * D + gz) * plane +
                      static_cast<int64_t>(gy) * W + gx);
          }
          sm.xs[c][kz][row][col] = v;
        }
        stage_weights(&sm.ws[0][0][0], w1k, c0, nc);
        __syncthreads();

#pragma unroll 1
        for (int c = 0; c < nc; ++c) {
#pragma unroll
          for (int kz = 0; kz < 3; ++kz) {
            float in[kRows1 + 2][3];
#pragma unroll
            for (int r = 0; r < kRows1 + 2; ++r)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx)
                in[r][dx] = sm.xs[c][kz][rg * kRows1 + r][lane + dx];
            fma_rows<kRows1>(acc, in, &sm.ws[c][kz * 9][ch0]);
          }
        }
      }

      const int gx = tx0 - 1 + lane;
#pragma unroll
      for (int o = 0; o < kChanPerThread; ++o) {
        const float s = __ldg(s1 + ch0 + o);
        const float b = __ldg(b1 + ch0 + o);
#pragma unroll
        for (int r = 0; r < kRows1; ++r) {
          const int row = rg * kRows1 + r;
          const int gy = ty0 - 1 + row;
          // zero outside the volume: conv2's SAME padding pads T
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
          tp[ch0 + o][row][lane] =
              inside ? fmaxf(acc[r][o] * s + b, 0.f) : 0.f;
        }
      }
    } else {
      // T planes -1 and D are conv2's zero padding
      float* flat = &tp[0][0][0];
      for (int i = threadIdx.x; i < kCo * kTY * kLanes; i += kThreads)
        flat[i] = 0.f;
    }

    if (j <= z0) continue;  // uniform over the CTA

    // ---- output plane z = j - 1 from T planes z-1, z, z+1
    const int z = j - 1;
    float acc[kRows2][kChanPerThread];
#pragma unroll
    for (int r = 0; r < kRows2; ++r)
#pragma unroll
      for (int o = 0; o < kChanPerThread; ++o) acc[r][o] = 0.f;
    // lanes 30, 31 own no output column; they read in range and store nothing
    const int lx = min(lane, kOutX - 1);

    for (int c0 = 0; c0 < kCo; c0 += kChunk) {
      __syncthreads();  // T plane j is written; the last reads of ws are done
      stage_weights(&sm.ws[0][0][0], w2k, c0, kChunk);
      __syncthreads();

#pragma unroll 1
      for (int c = 0; c < kChunk; ++c) {
#pragma unroll
        for (int kz = 0; kz < 3; ++kz) {
          const float(*src)[kLanes] = sm.t[(z + 2 + kz) % 3][c0 + c];
          float in[kRows2 + 2][3];
#pragma unroll
          for (int r = 0; r < kRows2 + 2; ++r)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
              in[r][dx] = src[rg * kRows2 + r][lx + dx];
          fma_rows<kRows2>(acc, in, &sm.ws[c][kz * 9][ch0]);
        }
      }
    }

    const int gx = tx0 + lane;
    if (lane < kOutX && gx < W) {
#pragma unroll
      for (int o = 0; o < kChanPerThread; ++o) {
        const float s = __ldg(s2 + ch0 + o);
        const float b = __ldg(b2 + ch0 + o);
        float* out =
            yn + (static_cast<int64_t>(ch0 + o) * D + z) * plane + gx;
#pragma unroll
        for (int r = 0; r < kRows2; ++r) {
          const int gy = ty0 + rg * kRows2 + r;
          if (gy < H)
            out[static_cast<int64_t>(gy) * W] = fmaxf(acc[r][o] * s + b, 0.f);
        }
      }
    }
  }
}

int launch(const float* x, const float* w1k, const float* s1, const float* b1,
           const float* w2k, const float* s2, const float* b2, float* y, int N,
           int ci, int D, int H, int W, void* stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  // above 48 KB a kernel has to opt in to its dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      convblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int z_chunks = (D + kZChunk - 1) / kZChunk;
  const dim3 grid((W + kOutX - 1) / kOutX, (H + kOutY - 1) / kOutY,
                  N * z_chunks);
  convblock_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      x, w1k, s1, b1, w2k, s2, b2, y, ci, D, H, W, z_chunks);
  return static_cast<int>(cudaGetLastError());
}


// ---- the bf16 tensor-core body --------------------------------------------

constexpr int kMOutX = 14;                   // output columns per CTA
constexpr int kMOutY = 8;                    // output rows per CTA
constexpr int kMTW = kMOutX + 2;             // T columns, and T's pitch
constexpr int kMTH = kMOutY + 2;             // T rows
constexpr int kMTPos = kMTH * kMTW;          // 160 T positions a plane
constexpr int kMTiles2 = kMOutY * kMTW / 64; // conv2: 2 tiles of 64 positions
// a T plane's words per channel group: conv2's last tap reads this far
constexpr int kMTWords = kMTiles2 * 64 + 2 * kMTW + 2;    // 162
constexpr int kMXW = kMTW + 2;               // staged x columns, and pitch
constexpr int kMXH = kMTH + 2;               // staged x rows
constexpr int kMXPos = kMXH * kMXW;          // 216
constexpr int kMTiles1 = 3;                  // conv1: 3 tiles cover T
static_assert((kMTH - 1) * kMXW + kMTW <= kMTiles1 * 64, "conv1 tiles");
constexpr int kMXWords = kMTiles1 * 64 + 2 * kMXW + 2;    // 230
constexpr int kPiece = 32;                   // channels of one staged piece
constexpr int kPieceGroups = kPiece / 8;
constexpr int kGroups = kCo / 8;             // channel groups of T
constexpr int kMThreads = mma::kWarpgroup;
constexpr int kW2Words = 27 * kCo * kCo / 8;
constexpr int kFmaItems = kMTPos / 32;       // T positions per lane (conv1 fma)

constexpr int mma_smem_bytes(bool mma1, int ci) {
  return (kW2Words + 3 * kGroups * kMTWords) * mma::kWord + 4 * kCo * 4 +
         (mma1 ? 27 * ci * kCo * 2 + 2 * kPieceGroups * kMXWords * mma::kWord
               : 3 * kMXPos * 4);
}

// w1: conv1's weights, packed [27][ci/8][32][8] bf16 if MMA1, else the
// (ci, 27, 32) f32 tile; w2p: conv2's, packed.
template <bool MMA1>
__global__ void __launch_bounds__(MMA1 ? 2 * kMThreads : kMThreads)
convblock_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const void* __restrict__ w1, const float* __restrict__ s1,
                     const float* __restrict__ b1,
                     const __nv_bfloat16* __restrict__ w2p,
                     const float* __restrict__ s2, const float* __restrict__ b2,
                     __nv_bfloat16* __restrict__ y, int ci, int D, int H, int W,
                     int z_chunks) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint4* w2s = reinterpret_cast<uint4*>(smem_raw);
  uint4* tring = w2s + kW2Words;
  float* aff = reinterpret_cast<float*>(tring + 3 * kGroups * kMTWords);
  uint4* w1s = reinterpret_cast<uint4*>(aff + 4 * kCo);       // MMA1
  uint4* xbuf = w1s + 27 * ci * kCo / 8;                      // MMA1
  float* xs = reinterpret_cast<float*>(aff + 4 * kCo);        // !MMA1

  const int tx0 = blockIdx.x * kMOutX;
  const int ty0 = blockIdx.y * kMOutY;
  const int n = blockIdx.z / z_chunks;
  const int z0 = (blockIdx.z % z_chunks) * kZChunk;
  const int z1 = min(z0 + kZChunk, D);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;           // within the warpgroup
  // MMA1 runs two warpgroups: the first starts the products and runs the
  // epilogues, the second stages conv1's input ahead of it
  constexpr int kThreadsAll = MMA1 ? 2 * kMThreads : kMThreads;
  const bool consumer = tid < kMThreads;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const __nv_bfloat16* xn = x + static_cast<int64_t>(n) * ci * D * plane;
  __nv_bfloat16* yn = y + static_cast<int64_t>(n) * kCo * D * plane;

  // MMA1: conv1's input comes in pieces of (one x plane, 32 channels). Piece
  // q of T plane j is x plane j - 1 + q / halves; the CTA's pieces, over its
  // T planes jf .. jl, are numbered in the order conv1 consumes them, and
  // piece p lies in xbuf[p & 1]. The second warpgroup keeps piece p + 2 in
  // flight in registers and stores piece p + 1 while piece p is multiplied.
  const int halves = ci / kPiece;
  const int pieces = 3 * halves;             // per T plane
  const int jf = max(z0 - 1, 0);
  const int n_pieces = (min(z1, D - 1) - jf + 1) * pieces;
  using Stage = mma::VecStage<kMThreads, kMXH, kMXW>;
  static_assert(Stage::max_units(kPieceGroups) <= Stage::kBatch * kMThreads,
                "a piece is at most kBatch units a thread");
  Stage regs;
  const bool vec = mma::vec_ok(xn, W);
  const int ptid = tid - kMThreads;
  auto load_piece = [&](int p) {
    if (!vec || p >= n_pieces) return;
    const int q = p % pieces;
    const int kd = q / halves;
    regs.load(xn, (q - kd * halves) * kPiece, kPieceGroups,
              jf + p / pieces - 1 + kd, ty0 - 2, tx0 - 2, D, H, W, ptid);
  };
  auto store_piece = [&](int p) {
    if (p >= n_pieces) return;
    uint4* dst = xbuf + (p & 1) * kPieceGroups * kMXWords;
    if (vec) {
      regs.store(dst, kMXWords, kPieceGroups, tx0 - 2, ptid);
    } else {
      const int q = p % pieces;
      const int kd = q / halves;
      mma::stage_plane_scalar<kMThreads, kMXH, kMXW>(
          dst, kMXWords, xn, (q - kd * halves) * kPiece, kPieceGroups,
          jf + p / pieces - 1 + kd, ty0 - 2, tx0 - 2, D, H, W, ptid);
    }
    mma::proxy_fence();
  };
  int pc = 0;  // pieces consumed so far

  mma::copy_words<kThreadsAll>(w2s, w2p, kW2Words);
  if (tid < kCo) {
    aff[tid] = __ldg(s1 + tid);
    aff[kCo + tid] = __ldg(b1 + tid);
    aff[2 * kCo + tid] = __ldg(s2 + tid);
    aff[3 * kCo + tid] = __ldg(b2 + tid);
  }
  if constexpr (MMA1) {
    mma::copy_words<kThreadsAll>(w1s, w1, 27 * ci * kCo / 8);
    if (!consumer) {
      load_piece(0);
      store_piece(0);
      load_piece(1);
    }
  }
  mma::proxy_fence();

  const uint32_t w1_addr = mma::smem_addr(w1s);
  const uint32_t w2_addr = mma::smem_addr(w2s);
  const uint32_t x_addr = mma::smem_addr(xbuf);
  const uint32_t t_addr = mma::smem_addr(tring);
  constexpr uint32_t kTile = 64 * mma::kWord;  // 64 consecutive positions

  for (int j = z0 - 1; j <= z1; ++j) {
    // conv2 of the previous step has read the ring slot this step overwrites
    __syncthreads();
    uint4* tslot = tring + ((j + 3) % 3) * kGroups * kMTWords;

    if (j >= 0 && j < D) {
      // ---- T plane j = relu(aff1(conv1(x))) on rows ty0-1.., cols tx0-1..
      if constexpr (MMA1) {
        float acc[kMTiles1][kCo / 2];
#pragma unroll
        for (int t = 0; t < kMTiles1; ++t)
#pragma unroll
          for (int i = 0; i < kCo / 2; ++i) acc[t][i] = 0.f;
        for (int q = 0; q < pieces; ++q, ++pc) {
          if (consumer) {
            const int kd = q / halves;
#pragma unroll
            for (int t = 0; t < kMTiles1; ++t) mma::fence_acc(acc[t]);
            mma::fence();
            mma::mma_plane<kCo, kMTiles1, kPiece / 16>(
                acc, x_addr + (pc & 1) * kPieceGroups * kMXWords * mma::kWord,
                kTile, kMXW * mma::kWord, kMXWords * mma::kWord,
                8 * mma::kWord,
                w1_addr + kd * 9 * ci * kCo * 2 +
                    (q - kd * halves) * (kPiece / 16) * 2 * kCo * mma::kWord,
                ci * kCo * 2);
            mma::commit();
            mma::wait_all();
#pragma unroll
            for (int t = 0; t < kMTiles1; ++t) mma::fence_acc(acc[t]);
          } else {
            // the next piece goes into the other buffer while the products
            // run, and the loads of the one after it start
            store_piece(pc + 1);
            load_piece(pc + 2);
          }
          __syncthreads();
        }
#pragma unroll
        for (int t = 0; t < kMTiles1; ++t) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = 64 * t + 16 * warp + (lane >> 2) + 8 * h;
            const int row = p / kMXW;
            const int col = p - row * kMXW;
            if (!consumer || col >= kMTW || row >= kMTH) continue;
            const int gy = ty0 - 1 + row;
            const int gx = tx0 - 1 + col;
            // zero outside the volume: conv2's SAME padding pads T
            const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
            uint4* word = tslot + row * kMTW + col;
#pragma unroll
            for (int g = 0; g < kGroups; ++g) {
              const int ch = 8 * g + 2 * (lane & 3);
              const float v0 = fmaxf(
                  acc[t][4 * g + 2 * h] * aff[ch] + aff[kCo + ch], 0.f);
              const float v1 = fmaxf(
                  acc[t][4 * g + 2 * h + 1] * aff[ch + 1] + aff[kCo + ch + 1],
                  0.f);
              reinterpret_cast<uint32_t*>(word + g * kMTWords)[lane & 3] =
                  inside ? mma::pack_pair(v0, v1) : 0u;
            }
          }
        }
      } else {
        // conv1 on the CUDA cores: a warp owns a channel group, a lane the
        // positions lane, lane + 32, ..
        const float* w1k = static_cast<const float*>(w1);
        float acc[kFmaItems][8];
#pragma unroll
        for (int k = 0; k < kFmaItems; ++k)
#pragma unroll
          for (int o = 0; o < 8; ++o) acc[k][o] = 0.f;
        for (int c = 0; c < ci; ++c) {
          if (c > 0) __syncthreads();  // the previous channel's reads are done
          for (int i = tid; i < 3 * kMXPos; i += kMThreads) {
            const int kd = i / kMXPos;
            const int pos = i - kd * kMXPos;
            const int row = pos / kMXW;
            const int gz = j - 1 + kd;
            const int gy = ty0 - 2 + row;
            const int gx = tx0 - 2 + pos - row * kMXW;
            float v = 0.f;
            if (gz >= 0 && gz < D && gy >= 0 && gy < H && gx >= 0 && gx < W)
              v = __bfloat162float(
                  xn[(static_cast<int64_t>(c) * D + gz) * plane +
                     static_cast<int64_t>(gy) * W + gx]);
            xs[i] = v;
          }
          __syncthreads();
#pragma unroll 1
          for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
            for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
              for (int kw = 0; kw < 3; ++kw) {
                const float4* wp = reinterpret_cast<const float4*>(
                    w1k + (static_cast<int64_t>(c) * 27 + (kd * 3 + kh) * 3 +
                           kw) * kCo + 8 * warp);
                const float4 wa = __ldg(wp);
                const float4 wb = __ldg(wp + 1);
                const float wv[8] = {wa.x, wa.y, wa.z, wa.w,
                                     wb.x, wb.y, wb.z, wb.w};
#pragma unroll
                for (int k = 0; k < kFmaItems; ++k) {
                  const int p = lane + 32 * k;
                  const float v = xs[kd * kMXPos + ((p >> 4) + kh) * kMXW +
                                     (p & 15) + kw];
#pragma unroll
                  for (int o = 0; o < 8; ++o)
                    acc[k][o] = fmaf(v, wv[o], acc[k][o]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kFmaItems; ++k) {
          const int p = lane + 32 * k;
          const int gy = ty0 - 1 + (p >> 4);
          const int gx = tx0 - 1 + (p & 15);
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
          uint32_t pair[4];
#pragma unroll
          for (int o = 0; o < 4; ++o) {
            const int ch = 8 * warp + 2 * o;
            pair[o] = mma::pack_pair(
                fmaxf(acc[k][2 * o] * aff[ch] + aff[kCo + ch], 0.f),
                fmaxf(acc[k][2 * o + 1] * aff[ch + 1] + aff[kCo + ch + 1],
                      0.f));
          }
          tslot[warp * kMTWords + p] =
              inside ? make_uint4(pair[0], pair[1], pair[2], pair[3])
                     : make_uint4(0u, 0u, 0u, 0u);
        }
      }
    } else {
      // T planes -1 and D are conv2's zero padding
      for (int i = tid; i < kGroups * kMTWords; i += kThreadsAll)
        tslot[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    mma::proxy_fence();
    __syncthreads();  // T plane j is written

    // ---- output plane z = j - 1 from T planes z-1, z, z+1
    const int z = j - 1;
    const bool out_step = j > z0;            // uniform over the CTA
    float acc[kMTiles2][kCo / 2];
    if (out_step && consumer) {
#pragma unroll
      for (int t = 0; t < kMTiles2; ++t) {
#pragma unroll
        for (int i = 0; i < kCo / 2; ++i) acc[t][i] = 0.f;
        mma::fence_acc(acc[t]);
      }
      mma::fence();
#pragma unroll
      for (int kd = 0; kd < 3; ++kd)
        mma::mma_plane<kCo, kMTiles2, kCo / 16>(
            acc,
            t_addr + ((z + 2 + kd) % 3) * kGroups * kMTWords * mma::kWord,
            kTile, kMTW * mma::kWord, kMTWords * mma::kWord, 8 * mma::kWord,
            w2_addr + kd * 9 * kCo * kCo * 2, kCo * kCo * 2);
      mma::commit();
    }
    if (!out_step || !consumer) continue;
    mma::wait_all();
#pragma unroll
    for (int t = 0; t < kMTiles2; ++t) mma::fence_acc(acc[t]);
#pragma unroll
    for (int t = 0; t < kMTiles2; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 64 * t + 16 * warp + (lane >> 2) + 8 * h;
        const int col = p % kMTW;
        const int gy = ty0 + p / kMTW;
        const int gx = tx0 + col;
        if (col >= kMOutX || gy >= H || gx >= W) continue;
        __nv_bfloat16* out = yn + static_cast<int64_t>(z) * plane +
                             static_cast<int64_t>(gy) * W + gx;
#pragma unroll
        for (int i = 0; i < 2 * kGroups; ++i) {
          const int ch = 8 * (i >> 1) + 2 * (lane & 3) + (i & 1);
          out[static_cast<int64_t>(ch) * D * plane] = __float2bfloat16(fmaxf(
              acc[t][4 * (i >> 1) + 2 * h + (i & 1)] * aff[2 * kCo + ch] +
                  aff[3 * kCo + ch],
              0.f));
        }
      }
    }
  }
}

template <bool MMA1>
int launch_mma(const void* x, const void* w1, const float* s1, const float* b1,
               const void* w2p, const float* s2, const float* b2, void* y,
               int N, int ci, int D, int H, int W, void* stream) {
  const int smem = mma_smem_bytes(MMA1, ci);
  if (smem > mma::kMaxSmem)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      convblock_mma_kernel<MMA1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int z_chunks = (D + kZChunk - 1) / kZChunk;
  const dim3 grid((W + kMOutX - 1) / kMOutX, (H + kMOutY - 1) / kMOutY,
                  N * z_chunks);
  convblock_mma_kernel<MMA1><<<grid, MMA1 ? 2 * kMThreads : kMThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), w1, s1, b1,
      static_cast<const __nv_bfloat16*>(w2p), s2, b2,
      static_cast<__nv_bfloat16*>(y), ci, D, H, W, z_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tpuseg

// y = relu(aff2(conv2(relu(aff1(conv1(x)))))) in f32 on the CUDA cores. x:
// (N, ci, D, H, W), y: (N, 32, D, H, W), f32, contiguous; w1k: (ci, 27, 32)
// and w2k: (32, 27, 32) f32, tap = (kd*3 + kh)*3 + kw; s*, b*: (32,) f32. The
// wrapper checks ceil(H/8) and N*ceil(D/16) <= 65535.
extern "C" int tpuseg_convblock(const float* x, const float* w1k,
                                const float* s1, const float* b1,
                                const float* w2k, const float* s2,
                                const float* b2, float* y, int N, int ci,
                                int D, int H, int W, void* stream) {
  return tpuseg::launch(x, w1k, s1, b1, w2k, s2, b2, y, N, ci, D, H, W,
                        stream);
}

// The same function in bf16 with conv2, and conv1 where mma1 = 1, on the
// tensor cores. x, y: bf16 as above; w2p: conv2's weights packed as
// [27][4][32][8] bf16 (ops/conv_mma.py); w1: conv1's packed the same way,
// [27][ci / 8][32][8], if mma1 = 1 (ci must be 32 or 64), else the
// (ci, 27, 32) f32 tile holding bf16 values (any ci). The wrapper checks
// ceil(H/8) and N*ceil(D/16) <= 65535.
extern "C" int tpuseg_convblock_mma(const void* x, const void* w1,
                                    const float* s1, const float* b1,
                                    const void* w2p, const float* s2,
                                    const float* b2, void* y, int N, int ci,
                                    int D, int H, int W, int mma1,
                                    void* stream) {
  if (!mma1)
    return tpuseg::launch_mma<false>(x, w1, s1, b1, w2p, s2, b2, y, N, ci, D,
                                     H, W, stream);
  if (ci != 32 && ci != 64) return static_cast<int>(cudaErrorInvalidValue);
  return tpuseg::launch_mma<true>(x, w1, s1, b1, w2p, s2, b2, y, N, ci, D, H,
                                  W, stream);
}
