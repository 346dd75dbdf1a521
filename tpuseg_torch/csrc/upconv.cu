// upsample_conv_cat: the decoder's nearest x2 upsample, (0, 1) pad, k=2
// conv, bias and skip concatenation in one pass on the H100's tensor cores.
//
// For NCDHW bf16 tensors x (N, ci, d, h, w) and skip (N, co, 2d, 2h, 2w):
//
//   y = cat([conv_k2(pad01(up2(x))) + bias, skip], dim=1)
//
// of shape (N, 2co, 2d, 2h, 2w).
//
// It replaces no Pallas kernel. The reference leaves this to XLA, which fuses
// its broadcast-reshape upsample (tpuseg/models/blocks.py, upsample2x) into
// the conv's input. The port's module path (models/blocks.Up.up and the
// concatenation of Up.forward) writes the x2 tensor, pads a copy of it,
// transposes that for cuDNN, adds the bias in another pass and concatenates
// into a third tensor.
//
// The parity form. Along an axis, fine output 2m reads x[m] under both taps,
// and 2m + 1 reads x[m] under tap 0 and x[m + 1] under tap 1, zero past the
// end (the pad). So for the parity class p = (pd, ph, pw) of a fine voxel,
//
//   out[2m + p] = sum over the 8 taps k = (kd, kh, kw) of w_k . x[m + (p & k)]
//
// which reads only the coarse tensor. These are the module path's products:
// every tap keeps its own bf16 weight (no two taps' weights are summed), the
// sum is kept in f32 and rounded once to bf16, and the bias is added as
// Conv3d adds it, bf16(float(bf16(sum)) + float(bias)), bias in bf16.
//
// The GEMM. A CTA owns 64 coarse voxels along w at one (n, d, h) (a tile)
// and 32 output channels; each parity class of the tile is a 64 x 32 x
// (8 taps x ci) product on wgmma (conv_mma.cuh). The A operand is a staged
// coarse window of 2 planes x 2 rows x 65 positions (the tile and its upper
// halo) in the interleaved layout [ci / 8][position][8 channels], so the
// shift (p & k) of every (class, tap) pair is a whole number of 16-byte
// words and one staged copy serves all 64 pairs. Positions outside the
// volume are staged as zeros: the pad. Windows hold 64 input channels, two
// in shared memory; the 32 channels' weights of all ci stay there too,
// packed [8 taps][ci / 8][32][8] by ops/upconv.py. A CTA walks a few rows
// of tiles along h, so the weights are staged once for several tiles.
//
// Two warpgroups, one per pd, each with the 4 classes (pd, ph, pw): 64 f32
// accumulators a thread. The next step's window is loaded into registers
// before the products are issued and stored into the other buffer after
// them, so its loads are in flight while the tensor cores work.
//
// What bounds it: bytes, nearly as much as operations. A 96 x 272 x 512
// block's up0 (64 -> 32 channels) writes 1.71 GB (the 64 concatenated
// channels), reads 0.86 GB of skip and 0.21 GB of x: 0.83 ms at 3.35 TB/s,
// against 0.44 TFLOP, 0.44 ms on the tensor cores (0.67 ms at the two
// thirds of their rate that N = 32 from shared memory allows). So every
// byte of y is written once, straight from the accumulators: a thread holds
// two neighbouring channels of a coarse voxel, whose pw = 0 and pw = 1
// classes are neighbours along the fine w axis, one 4-byte word; a warp's
// store fills whole 32-byte sectors (8 neighbouring voxels of 4 channels).
// The skip is copied in the same pass in 16-byte vectors, one piece per
// class, each piece's loads started before that class's products are issued
// and stored after. No intermediate tensor reaches device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv_mma.cuh"

namespace tpuseg {
namespace {

constexpr int kNC = 32;                  // output channels of a CTA (GEMM N)
constexpr int kKC = 64;                  // input channels staged at a time
constexpr int kKGroups = kKC / 8;        // their 16-byte channel groups
constexpr int kKSteps = kKC / 16;        // wgmma depth steps of a piece
constexpr int kTile = 64;                // coarse voxels of a tile, along w
constexpr int kPitch = kTile + 1;        // staged positions a row: + halo
constexpr int kRows = 4;                 // staged rows: 2 planes x 2 rows
constexpr int kGroupWords = kRows * kPitch;
constexpr int kAWords = kKGroups * kGroupWords;      // 2,080 (33,280 bytes)
constexpr int kThreads = 2 * mma::kWarpgroup;        // warpgroup q: pd = q
constexpr int kMaxCi = 320;              // weights + two windows in smem
// the skip copy of a tile: 4 fine rows x 32 channels x 16 vectors of 8
// fine voxels (16 bytes), 8 vectors a thread
constexpr int kSkipVecs = 4 * kNC * (2 * kTile / 8);
static_assert(kSkipVecs == 8 * kThreads, "skip units");
// a window's 16-byte vectors (8 positions of 8 channels): one a thread
static_assert(kKGroups * kRows * (kTile / 8) == kThreads, "window units");

constexpr int smem_bytes(int ci) {
  return (ci * kNC + 2 * kAWords) * mma::kWord;
}

// One staged window (a piece of 64 input channels; planes md, md + 1, rows
// mh, mh + 1, positions w0 .. w0 + 64 in the interleaved layout
// [8 groups][4 rows][kPitch][8 channels]), this thread's share of it kept
// in registers between load() and store(): the vector of unit tid (group,
// row, 8 positions; consecutive threads take consecutive vectors of a row)
// and, for tid < 32, the halo position 64 of one (group, row). Vectors
// need W % 8 == 0 and a 16-byte aligned x (mma::vec_ok); a vector is
// wholly inside or outside the volume, and outside reads as zeros (the
// pad, and the ragged tile).
struct Window {
  uint32_t body[8][4];
  uint32_t halo[4];

  __device__ __forceinline__ void load(const __nv_bfloat16* xn, int c0,
                                       int md, int mh, int w0, int D, int H,
                                       int W, int tid) {
    const int64_t plane = static_cast<int64_t>(H) * W;
    const int64_t chan = static_cast<int64_t>(D) * plane;
    {
      const int g = tid / (kRows * kTile / 8);
      const int r = (tid / (kTile / 8)) % kRows;
      const int gx = w0 + 8 * (tid % (kTile / 8));
      const int gz = md + (r >> 1);
      const int gy = mh + (r & 1);
      const bool in = gz < D && gy < H && gx < W;
      const uint4* p = reinterpret_cast<const uint4*>(
          xn + (c0 + 8 * g) * chan + gz * plane +
          static_cast<int64_t>(gy) * W + gx);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint4 v = in ? __ldg(p + k * chan / 8) : make_uint4(0, 0, 0, 0);
        body[k][0] = v.x;
        body[k][1] = v.y;
        body[k][2] = v.z;
        body[k][3] = v.w;
      }
    }
    if (tid < kKGroups * kRows) {
      const int g = tid / kRows;
      const int r = tid % kRows;
      const int gx = w0 + kTile;
      const int gz = md + (r >> 1);
      const int gy = mh + (r & 1);
      const bool in = gz < D && gy < H && gx < W;
      const unsigned short* p = reinterpret_cast<const unsigned short*>(
          xn + (c0 + 8 * g) * chan + gz * plane +
          static_cast<int64_t>(gy) * W + gx);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t lo = in ? __ldg(p + 2 * k * chan) : 0u;
        const uint32_t hi = in ? __ldg(p + (2 * k + 1) * chan) : 0u;
        halo[k] = lo | (hi << 16);
      }
    }
  }

  __device__ __forceinline__ void store(uint4* dst, int tid) const {
    const int g = tid / (kRows * kTile / 8);
    const int r = (tid / (kTile / 8)) % kRows;
    uint4* row = dst + g * kGroupWords + r * kPitch + 8 * (tid % (kTile / 8));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // position j: the low (even j) or high (odd j) half of register j / 2
      // of every channel
      const uint32_t sel = (j & 1) ? 0x7632 : 0x5410;
      row[j] = make_uint4(__byte_perm(body[0][j >> 1], body[1][j >> 1], sel),
                          __byte_perm(body[2][j >> 1], body[3][j >> 1], sel),
                          __byte_perm(body[4][j >> 1], body[5][j >> 1], sel),
                          __byte_perm(body[6][j >> 1], body[7][j >> 1], sel));
    }
    if (tid < kKGroups * kRows)
      dst[(tid / kRows) * kGroupWords + (tid % kRows) * kPitch + kTile] =
          make_uint4(halo[0], halo[1], halo[2], halo[3]);
  }
};

// The same window for any W and alignment: 2-byte loads, stored at once.
__device__ __forceinline__ void stage_scalar(uint4* dst,
                                             const __nv_bfloat16* xn, int c0,
                                             int md, int mh, int w0, int D,
                                             int H, int W, int tid) {
#pragma unroll
  for (int pl = 0; pl < 2; ++pl)
    mma::stage_plane_scalar<kThreads, 2, kPitch>(
        dst + pl * 2 * kPitch, kGroupWords, xn, c0, kKGroups, md + pl, mh, w0,
        D, H, W, tid);
}

// The tile's skip copy, this thread's 8 vectors of 8 fine voxels along w:
// vector tid % 16 of the tile's 128 fine w, channel tid / 16 + 16 e (e < 2)
// of the chunk, and the 4 fine rows (2 md + pd, 2 mh + ph), piece i =
// 2 pd + ph; warpgroup q's threads take channels 8q .. 8q + 7 (+ 16).
// Needs W % 4 == 0 and 16-byte aligned skip and y; else the tile's rows
// are copied in 4-byte words (copy_skip_words) and `in` is false.
struct SkipCopy {
  const uint4* src;   // the thread's first vector in fine row (2 md, 0)
  uint4* dst;
  int64_t half;       // 16 channels, in vectors
  int64_t plane;      // a fine z plane, in vectors
  int row;            // a fine row (2W), in vectors
  bool in;            // vectors in use, and this one inside the fine w
  int64_t at;         // fine row 2 mh of the current tile row

  // sn, ysn: the chunk's channel 0 of skip and of y's copy of it, at the
  // tile's first fine plane (2 md)
  __device__ __forceinline__ void init(const __nv_bfloat16* sn,
                                       __nv_bfloat16* ysn, int64_t fvol,
                                       int64_t fplane, int W, int w0,
                                       int tid, bool vec) {
    const int64_t o = ((tid >> 4) * fvol + 2 * w0) / 8 + (tid & 15);
    src = reinterpret_cast<const uint4*>(sn) + o;
    dst = reinterpret_cast<uint4*>(ysn) + o;
    half = 16 * fvol / 8;
    plane = fplane / 8;
    row = W / 4;
    in = vec && 2 * w0 + 8 * (tid & 15) < 2 * W;
  }
  __device__ __forceinline__ int64_t offset(int i, int e) const {
    return at + (i >> 1) * plane + (i & 1) * row + e * half;
  }
  __device__ __forceinline__ void load(uint4 (&v)[2], int i) const {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      v[e] = in ? __ldg(src + offset(i, e)) : make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ void store(const uint4 (&v)[2], int i) const {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (in) dst[offset(i, e)] = v[e];
  }
};

// The tile's skip copy for any W and alignment: 4-byte words (2 fine
// voxels), consecutive threads on consecutive words.
// src, dst: as SkipCopy::init's sn, ysn; chan, fplane in words.
__device__ __forceinline__ void copy_skip_words(const __nv_bfloat16* sn,
                                                __nv_bfloat16* ysn,
                                                int64_t chan, int64_t fplane,
                                                int fy, int w0, int W,
                                                int tid) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(sn);
  uint32_t* dst = reinterpret_cast<uint32_t*>(ysn);
  for (int u = tid; u < 4 * kNC * kTile; u += kThreads) {
    const int word = u & (kTile - 1);
    const int ch = (u / kTile) % kNC;
    const int fr = u / kTile / kNC;
    if (w0 + word >= W) continue;
    const int64_t o = ch * chan + (fr >> 1) * fplane +
                      static_cast<int64_t>(fy + (fr & 1)) * W + w0 + word;
    dst[o] = __ldg(src + o);
  }
}

// bf16(float(bf16(acc)) + bias): Conv3d's rounding of the sum, then its
// bias add in bf16 arithmetic (the final rounding is pack_pair's).
__device__ __forceinline__ float conv_bias(float acc, float bias) {
  return __bfloat162float(__float2bfloat16(acc)) + bias;
}

// The products of one staged piece of 64 input channels for this
// warpgroup's 4 parity classes p = (pd, i / 2, i % 2): acc[i] += sum over
// the 8 taps k of the window shifted by (p & k) times w_k. da, db: the
// descriptors of the window's first position and of the piece's first
// weights; each product's is one of them plus a constant (16-byte units).
// With COPY, piece i of the thread's skip copy is loaded before class i's
// products are issued and stored after, while the tensor cores work
// through the queue. Straight-line code: the trip counts are compile-time
// constants (see mma_plane in conv_mma.cuh).
template <bool COPY>
__device__ __forceinline__ void products(float (&acc)[4][kNC / 2], int pd,
                                         uint64_t da, uint64_t db,
                                         uint32_t tap, const SkipCopy& skip) {
  const uint64_t da_z = da + pd * 2 * kPitch;  // shifted a plane if pd
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint4 v[2];
    if constexpr (COPY) skip.load(v, i);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      // the shift (p & k): its z bit is pd & kd, its h and w bits i & k
      const uint64_t a = ((k >> 2) ? da_z : da) +
                         ((i & k) >> 1) * kPitch + (i & k & 1);
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        mma::wgmma(acc[i], a + ks * 2 * kGroupWords,
                   db + k * tap + ks * 2 * kNC);
    }
    if constexpr (COPY) skip.store(v, i);
  }
}

// grid: (w tiles x row groups, N x D, co / 32); D, H, W are the coarse
// extents; each CTA walks `rows` rows of tiles along h, a step a row and
// piece of 64 input channels. Warpgroup q computes the classes pd = q.
__global__ void __launch_bounds__(kThreads, 1)
upconv_cat_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ skip,
                  const __nv_bfloat16* __restrict__ wp,
                  const __nv_bfloat16* __restrict__ bias,
                  __nv_bfloat16* __restrict__ y, int ci, int co, int D, int H,
                  int W, int rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint4* ws = reinterpret_cast<uint4*>(smem_raw);   // ci * 32 words
  uint4* as = ws + ci * kNC;                         // 2 windows

  const int tid = threadIdx.x;
  const int pd = tid / mma::kWarpgroup;
  const int lane = tid & 31;
  const int warp = (tid & (mma::kWarpgroup - 1)) >> 5;
  const int w_tiles = (W + kTile - 1) / kTile;
  const int w0 = (blockIdx.x % w_tiles) * kTile;
  const int h0 = (blockIdx.x / w_tiles) * rows;
  const int n = blockIdx.y / D;
  const int md = blockIdx.y - n * D;
  const int nc = blockIdx.z;
  const int pieces = ci / kKC;
  const int steps = (min(h0 + rows, H) - h0) * pieces;

  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t fplane = 4 * plane;                  // fine (2H, 2W) plane
  const int64_t fvol = 2 * D * fplane;               // fine volume
  const int64_t chan = fvol / 2;                     // a channel of y, words
  const __nv_bfloat16* xn = x + static_cast<int64_t>(n) * ci * D * plane;
  __nv_bfloat16* yn = y + (static_cast<int64_t>(n) * 2 * co + nc * kNC) * fvol;
  const __nv_bfloat16* sn =
      skip + (static_cast<int64_t>(n) * co + nc * kNC) * fvol + 2 * md * fplane;
  __nv_bfloat16* ysn = yn + static_cast<int64_t>(co) * fvol + 2 * md * fplane;
  const bool vec_skip = W % 4 == 0 &&
                        (reinterpret_cast<uintptr_t>(sn) & 15) == 0 &&
                        (reinterpret_cast<uintptr_t>(ysn) & 15) == 0;
  SkipCopy copy;
  copy.init(sn, ysn, fvol, fplane, W, w0, tid, vec_skip);

  // the chunk's weights, all ci, once a CTA; the first window
  mma::copy_words<kThreads>(ws, wp + static_cast<int64_t>(nc) * 8 * ci * kNC,
                            ci * kNC);
  float bias_r[kNC / 8][2];
#pragma unroll
  for (int j = 0; j < kNC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bias_r[j][e] =
          __bfloat162float(bias[nc * kNC + 8 * j + 2 * (lane & 3) + e]);
  const bool vec = mma::vec_ok(xn, W);
  Window win;
  if (vec) {
    win.load(xn, 0, md, h0, w0, D, H, W, tid);
    win.store(as, tid);
  } else {
    stage_scalar(as, xn, 0, md, h0, w0, D, H, W, tid);
  }
  mma::proxy_fence();
  __syncthreads();

  const uint64_t da0 = mma::desc_at(
      mma::desc_strides(kGroupWords * mma::kWord, 8 * mma::kWord),
      mma::smem_addr(as));
  const uint64_t db0 = mma::desc_at(
      mma::desc_strides(kNC * mma::kWord, 8 * mma::kWord), mma::smem_addr(ws));
  const uint32_t tap = ci / 8 * kNC;    // one tap's weights, in words
  float acc[4][kNC / 2];
  for (int s = 0; s < steps; ++s) {
    const int mh = h0 + s / pieces;
    const int c = s % pieces;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNC / 2; ++j) acc[i][j] = 0.f;
      copy.at = static_cast<int64_t>(2 * mh) * copy.row;
    }
    // the next step's window: its loads in flight during the products
    const bool next = s + 1 < steps;
    const int mh1 = h0 + (s + 1) / pieces;
    const int c1 = (s + 1) % pieces;
    if (vec && next) win.load(xn, c1 * kKC, md, mh1, w0, D, H, W, tid);
#pragma unroll
    for (int i = 0; i < 4; ++i) mma::fence_acc(acc[i]);
    mma::fence();
    const uint64_t da = da0 + (s & 1) * kAWords;
    const uint64_t db = db0 + c * kKGroups * kNC;
    if (c == 0 && vec_skip)
      products<true>(acc, pd, da, db, tap, copy);
    else
      products<false>(acc, pd, da, db, tap, copy);
    mma::commit();
    mma::wait_all();
#pragma unroll
    for (int i = 0; i < 4; ++i) mma::fence_acc(acc[i]);
    if (next) {
      uint4* dst = as + ((s + 1) & 1) * kAWords;
      if (vec)
        win.store(dst, tid);
      else
        stage_scalar(dst, xn, c1 * kKC, md, mh1, w0, D, H, W, tid);
      mma::proxy_fence();
    }
    if (c == 0 && !vec_skip)
      copy_skip_words(sn, ysn, chan, fplane / 2, 2 * mh, w0, W, tid);
    __syncthreads();
    if (c != pieces - 1) continue;

    // classes (pd, ph, 0) and (pd, ph, 1) of a coarse voxel are one word
#pragma unroll
    for (int ph = 0; ph < 2; ++ph) {
      uint32_t* out = reinterpret_cast<uint32_t*>(
          yn + (2 * md + pd) * fplane +
          static_cast<int64_t>(2 * mh + ph) * 2 * W);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int mw = w0 + 16 * warp + (lane >> 2) + 8 * hh;
        if (mw >= W) continue;
#pragma unroll
        for (int j = 0; j < kNC / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            out[(8 * j + 2 * (lane & 3) + e) * chan + mw] =
                mma::pack_pair(conv_bias(acc[2 * ph][i], bias_r[j][e]),
                               conv_bias(acc[2 * ph + 1][i], bias_r[j][e]));
          }
        }
      }
    }
  }
}

}  // namespace
}  // namespace tpuseg

// y = cat([conv_k2(pad01(up2(x))) + bias, skip], 1) in bf16, NCDHW,
// contiguous: x (N, ci, D, H, W), skip (N, co, 2D, 2H, 2W), y (N, 2co, 2D,
// 2H, 2W); wp: the k=2 conv's weights packed [co / 32][8 taps][ci / 8][32][8]
// bf16, tap = kd * 4 + kh * 2 + kw (ops/upconv.py); bias: (co,) bf16. ci a
// multiple of 64 up to 320, co of 32; each CTA walks `rows` rows of tiles.
// The wrapper checks N * D <= 65535, co / 32 <= 65535 and the pointers'
// alignment (x 16 bytes for the vector staging, which falls back to 2-byte
// loads otherwise; skip and y 4 bytes).
extern "C" int tpuseg_upsample_conv_cat(const void* x, const void* skip,
                                        const void* wp, const void* bias,
                                        void* y, int N, int ci, int co, int D,
                                        int H, int W, int rows, void* stream) {
  using namespace tpuseg;
  if (ci % kKC != 0 || ci > kMaxCi || co % kNC != 0 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(ci);
  cudaError_t err = cudaFuncSetAttribute(
      upconv_cat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int w_tiles = (W + kTile - 1) / kTile;
  const dim3 grid(w_tiles * ((H + rows - 1) / rows), N * D, co / kNC);
  upconv_cat_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(skip),
      static_cast<const __nv_bfloat16*>(wp),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), ci, co, D, H, W, rows);
  return static_cast<int>(cudaGetLastError());
}
