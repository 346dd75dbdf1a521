// R1: SwinUNETR's ResBlock 3x3x3 SAME convolution, bias-free, on the H100.
//
//   y[n, o, z, y, x] = sum_{c, kd, kh, kw} w[o, c, kd, kh, kw]
//                      * x[n, c, z + kd - 1, y + kh - 1, x + kw - 1]
//
// NCDHW bf16 in and out, bf16 operands, float32 sums, each output rounded to
// bf16 once; out-of-volume taps read zero. It replaces no Pallas kernel:
// SwinUNETR is the port's own net (models/swin_unetr.py), whose ResBlocks
// ran cuDNN's Ampere implicit-GEMM kernels on NCDHW tensors, with a layout
// transpose into NDHWC before and out after every call.
//
// What bounds it: operations. A tile batch of four 96^3 blocks' 48 -> 48
// conv is 0.44 TFLOP against 57 MB of input and output (0.45 ms at 989
// TFLOP/s, 0.017 ms at 3.35 TB/s); the deepest calls (3^3, 768 -> 768) are
// 3.4 GFLOP against 32 MB of weights. Two bodies; the wrapper
// (ops/rconv.py, rconv_plan) picks one and its launch from the shape alone:
//
// * BoxBody (ci a multiple of 16, co of 48; every level from 96^3 to 3^3): an
//   implicit GEMM on wgmma in conv_mma.cuh's layout, output voxels as the M
//   side. A unit of work is a box of 4 planes x 8 rows x BX columns (each
//   8 x 8 patch one 64-row M tile) and NC output channels (the N side: 48,
//   or 96 where co is a multiple of 96; BX 16 or 8, so 96 float32
//   accumulators a thread either way). Its depth, 27 taps x ci, runs in
//   chunks of 16 input channels; a chunk's halo is staged [2 groups]
//   [position][8 channels] from 16-byte vector loads of NCDHW rows,
//   transposed 8 x 8 in registers (the re-lay that makes cuDNN's layout
//   transposes unnecessary; 2-byte loads where W is not a multiple of 8),
//   so each tap is a descriptor shift of one staged copy, and its packed
//   weights, [27][2][NC][8] (41 or 83 KB), stream in by cp.async: a
//   ResBlock conv's weights do not fit in shared memory (dec0's 96 -> 48
//   alone is 249 KB). Shared-memory feed: an m64n48k16 reads 2 KB of A
//   and 1.5 KB of B for 24 tensor-core clocks, 28 clocks at 128 bytes a
//   clock, so N = 48 (the 96^3 and 48^3 levels, 87% of the work) tops out
//   near 86% of the tensor rate; with co = 48 as the M side a 64-row tile
//   would be a quarter empty, so the channels stay the N side. Without
//   staging the products alone ran at ~720 TFLOP/s (96 -> 48 at 96^3,
//   measured with the staging left out).
// * rconv_ci1_kernel (ci = 1: enc0's first conv): 27 x co multiply-adds a
//   voxel on the CUDA cores' float32 pipes. Its bound is its bytes: 2 x co
//   written a voxel, a 96^3 tile batch's 340 MB, 0.10 ms a call at 3.35
//   TB/s; the 27 x 48 float32 FMAs a voxel take 0.14 ms at the CUDA cores'
//   67 TFLOP/s, so on these pipes it cannot reach that bound. A CTA stages a (4 + 2) x (16 + 2) x (32 + 2) float32 halo of
//   one sample; warp w computes output channels 4w .. 4w + 3 (their 108
//   weights in registers), lane l column l, marching down the rows with a 3
//   x 3 x 3 window of inputs in registers (9 loads a row for 108 FMAs),
//   reading the module's float32 weights and rounding them to bf16 itself.
//   A warp's stores of a channel are 64 contiguous bytes.
//
// The box body runs on a skeleton (rconv_kernel): persistent
// CTAs of two warpgroups, one an SM, each walking its share of the units;
// two stages of (halo, weights) in shared memory, 152 to 204 KB; a step's
// products are issued as three groups, one a kd plane, and the next step's
// staging is cut between them (see the skeleton's note), so its loads fly
// while the tensor cores work; the next unit's first chunk is staged during
// the current one's last. The epilogue stages the bf16 box through the
// stage it has just consumed and stores whole 16-byte vectors along x (a
// separate 49 KB tile, which left less L1, was 10-20% slower). Where the
// units fill less than one wave of the card (the 6^3 and 3^3 levels), the
// depth splits over `split` units that write float32 partial sums, and
// rconv_reduce_kernel adds them in a fixed order and rounds once. No
// atomics: the same input gives the same bits on every call.
// rconv_pack_kernel packs the module's float32 weights in one pass a call
// (4 bytes read, 2 written a weight).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv_mma.cuh"

namespace tpuseg {
namespace {

constexpr int kKC = 16;                          // input channels a chunk
constexpr int kGroups = kKC / 8;                 // their 16-byte groups

// d = A * B + (scale_d ? d : 0) for one 64 x N x 16 step, N = 48 or 96
// (see conv_mma.cuh). scale_d 0 starts a sum without zeroing d first:
// an instruction that wrote the accumulators while earlier products are
// in flight would make ptxas serialize the chain (C7515).
__device__ __forceinline__ void wgmma(float (&d)[24], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma(float (&d)[48], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}
// ---- the tensor-core body's pipelined skeleton ---------------------------
//
// Two warpgroups both stage and issue wgmma. A warpgroup that issues a
// chunk's 27 x MT asynchronous wgmma stalls on their issue until most have
// run, so staging placed after the products would not overlap them
// (measured: it added its whole time). So a chunk's products are issued as
// three groups, one a kd plane, and the next chunk's staging is cut around
// them (rconv_kernel's note). (A producer warpgroup staging alone, with two
// warpgroups issuing, was slower: 128 threads did not keep up.)
constexpr int kThreads = 2 * mma::kWarpgroup;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   mma::smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Wait until at most one group of this warpgroup's wgmma is in flight.
__device__ __forceinline__ void wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// n 16-byte words of packed weights into shared memory by cp.async
__device__ __forceinline__ void copy_weights(uint4* dst, const uint4* src,
                                            int n, int tid) {
  for (int i = tid; i < n; i += kThreads) cp_async16(dst + i, src + i);
  cp_async_commit();
}
// eight 2-byte channels as one interleaved word
__device__ __forceinline__ uint4 word_of(const unsigned short (&v)[8]) {
  return make_uint4(v[0] | (static_cast<uint32_t>(v[1]) << 16),
                    v[2] | (static_cast<uint32_t>(v[3]) << 16),
                    v[4] | (static_cast<uint32_t>(v[5]) << 16),
                    v[6] | (static_cast<uint32_t>(v[7]) << 16));
}

// What a call computes. wp: the weights packed [co / nc][ci / 16][27][2]
// [nc][8] (rconv_pack_kernel). split 1 writes y in bf16; else part[s]
// (float32, N * co * D * H * W each), piece s summing chunks [s, s + 1) *
// ci / 16 / split.
struct Conv {
  const __nv_bfloat16* x;
  const __nv_bfloat16* wp;
  __nv_bfloat16* y;
  float* part;
  int N, ci, co, D, H, W, split;
};

// ---- the box body: output voxels as the M side ---------------------------
//
// A unit is a box of BZ planes x 8 rows x BX columns of one sample (each 8 x
// 8 patch of a plane one 64-row M tile, MT a warpgroup: planes BZ / 2
// each), NC output channels (the N side) and a depth piece; units run box
// fastest, then channel chunk, piece and sample. A chunk's halo, (BZ + 2) x
// 10 x (BX + 2) positions of 16 channels, is staged [2 groups][position][8
// channels] (conv_mma.cuh's layout) so that each tap is a descriptor shift
// of one staged copy; its weights, [27][2][NC][8], stream in by cp.async.
template <int NC, bool VEC>
struct BoxBody {
  static constexpr int BZ = 4;
  static constexpr int BX = NC == 48 ? 16 : 8;
  static constexpr int kTilesX = BX / 8;
  static constexpr int MT = BZ * kTilesX / 2;
  static constexpr int WZ = BZ + 2, WY = 10, WX = BX + 2;   // the halo
  static constexpr int kWin = WZ * WY * WX;        // positions of a group
  static constexpr int kAWords = kGroups * kWin;   // 16-byte words
  static constexpr int kWWords = 27 * kKC * NC / 8;
  static constexpr int kStage = kAWords + kWWords;
  // 8-voxel vectors a halo row touches (x0 a multiple of 8)
  static constexpr int kVecs = BX / 8 + 2;
  static constexpr int kUnits = kGroups * WZ * WY * kVecs;
  // NC 48 (the 96^3 and 48^3 levels, large outputs) stages the bf16 box in
  // shared memory for its stores, a channel padded by 8 values so that the
  // four channels a store instruction writes fall in four bank groups
  static constexpr bool kStagedOut = NC == 48;
  static constexpr int kOutPitch = BZ * 8 * BX + 8;
  static_assert(NC * kOutPitch * 2 <= kStage * mma::kWord, "output tile");
  static constexpr int kSmem = 2 * kStage * mma::kWord;
  using Acc = float[MT][NC / 2];

  Conv p;
  int boxes_x, boxes_y, boxes, co_chunks, total, chunks;
  int64_t vol;

  __device__ explicit BoxBody(const Conv& c) : p(c) {
    boxes_x = (p.W + BX - 1) / BX;
    boxes_y = (p.H + 7) / 8;
    boxes = boxes_x * boxes_y * ((p.D + BZ - 1) / BZ);
    co_chunks = p.co / NC;
    total = boxes * co_chunks * p.split * p.N;
    chunks = p.ci / kKC / p.split;
    vol = static_cast<int64_t>(p.D) * p.H * p.W;
  }

  struct Unit {
    int x0, y0, z0, nc, s, n;
  };
  __device__ Unit unit(int u) const {
    Unit g;
    int b = u % boxes;
    u /= boxes;
    g.nc = u % co_chunks;
    u /= co_chunks;
    g.s = u % p.split;
    g.n = u / p.split;
    g.x0 = (b % boxes_x) * BX;
    b /= boxes_x;
    g.y0 = (b % boxes_y) * 8;
    g.z0 = (b / boxes_y) * BZ;
    return g;
  }

  // Chunk c of unit u into stage st: weights() by cp.async; the halo in two
  // halves. load(): for VEC (W a multiple of 8, 16-byte aligned rows) the
  // halo's global loads into registers: a unit is (group, plane, row,
  // vector of 8 x) of the window, position (pz, row, col) = voxel (z0 - 1 +
  // pz, y0 - 1 + row, x0 - 1 + col), zero outside the volume; a thread
  // loads the vector of each of the group's 8 channels. store(): VEC
  // transposes each 8 x 8 in registers and stores the words that fall in
  // the window (conv_mma.cuh's VecStage in 3D); else it stages the window
  // here, one position a unit, eight 2-byte loads packed into one word.
  struct Regs {
    uint32_t v[2][8][4];  // a halo vector of 8 channels, a half
  };
  static_assert(kUnits <= 2 * kThreads, "halo vectors: one a thread a half");

  __device__ void weights(int u, int c, uint4* st, int tid) const {
    const Unit g = unit(u);
    copy_weights(st + kAWords,
                 reinterpret_cast<const uint4*>(p.wp) +
                     (static_cast<int64_t>(g.nc) * (p.ci / kKC) + g.s * chunks +
                      c) * kWWords,
                 kWWords, tid);
  }

  // half h of the halo: VEC loads unit batch h into registers
  template <int HALF>
  __device__ void load(Regs& r, int u, int c, int tid) const {
    const Unit g = unit(u);
    const int cc = g.s * chunks + c;
    if constexpr (VEC) {
      const __nv_bfloat16* xn =
          p.x + (static_cast<int64_t>(g.n) * p.ci + cc * kKC) * vol;
      const int64_t plane = static_cast<int64_t>(p.H) * p.W;
      const int64_t chan = vol / 8;                      // in vectors
      const int v0 = (g.x0 - 1) >> 3;
      {
        const int e = tid + HALF * kThreads;
        const int vx = e % kVecs;
        int t = e / kVecs;
        const int row = t % WY;
        t /= WY;
        const int pz = t % WZ;
        const int grp = t / WZ;
        const int gz = g.z0 - 1 + pz, gy = g.y0 - 1 + row;
        const int gx = 8 * (v0 + vx);
        const bool in = e < kUnits && gz >= 0 && gz < p.D && gy >= 0 &&
                        gy < p.H && gx >= 0 && gx < p.W;
        const uint4* q = reinterpret_cast<const uint4*>(
            xn + 8 * grp * vol + gz * plane + static_cast<int64_t>(gy) * p.W +
            gx);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint4 w4 =
              in ? __ldg(q + k * chan) : make_uint4(0u, 0u, 0u, 0u);
          r.v[HALF][k][0] = w4.x;
          r.v[HALF][k][1] = w4.y;
          r.v[HALF][k][2] = w4.z;
          r.v[HALF][k][3] = w4.w;
        }
      }
    }
  }

  template <int HALF>
  __device__ void store(const Regs& r, int u, int c, uint4* st,
                        int tid) const {
    const Unit g = unit(u);
    if constexpr (VEC) {
      const int v0 = (g.x0 - 1) >> 3;
      const int e = tid + HALF * kThreads;
      if (e < kUnits) {
        const int col0 = 8 * (v0 + e % kVecs) - (g.x0 - 1);
        uint4* row = st + (e / kVecs) * WX;       // [grp][pz][row] rows
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t sel = (j & 1) ? 0x7632 : 0x5410;
          uint4 word;
          const uint32_t(&v)[8][4] = r.v[HALF];
          word.x = __byte_perm(v[0][j >> 1], v[1][j >> 1], sel);
          word.y = __byte_perm(v[2][j >> 1], v[3][j >> 1], sel);
          word.z = __byte_perm(v[4][j >> 1], v[5][j >> 1], sel);
          word.w = __byte_perm(v[6][j >> 1], v[7][j >> 1], sel);
          if (col0 + j >= 0 && col0 + j < WX) row[col0 + j] = word;
        }
      }
    } else if (HALF == 0) {
      const int cc = g.s * chunks + c;
      const unsigned short* src = reinterpret_cast<const unsigned short*>(
          p.x + (static_cast<int64_t>(g.n) * p.ci + cc * kKC) * vol);
      const int64_t plane = static_cast<int64_t>(p.H) * p.W;
      for (int u0 = tid; u0 < kAWords; u0 += 4 * kThreads) {
        unsigned short v[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = u0 + i * kThreads;
          const int col = e % WX;
          int t = e / WX;
          const int row = t % WY;
          t /= WY;
          const int pz = t % WZ;
          const int grp = t / WZ;
          const int gz = g.z0 - 1 + pz, gy = g.y0 - 1 + row;
          const int gx = g.x0 - 1 + col;
          const bool in = e < kAWords && gz >= 0 && gz < p.D && gy >= 0 &&
                          gy < p.H && gx >= 0 && gx < p.W;
          const unsigned short* q = src + 8 * grp * vol + gz * plane +
                                    static_cast<int64_t>(gy) * p.W + gx;
#pragma unroll
          for (int k = 0; k < 8; ++k) v[i][k] = in ? __ldg(q + k * vol) : 0;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (u0 + i * kThreads < kAWords)
            st[u0 + i * kThreads] = word_of(v[i]);
      }
    }
  }

  __device__ static void fence(Acc& acc) {
#pragma unroll
    for (int t = 0; t < MT; ++t) mma::fence_acc(acc[t]);
  }

  // The 9 taps of plane KD of the chunk in the stage at st_addr for
  // warpgroup wg's MT tiles: acc[t] += A_t(tap) * W(tap), the first tap of
  // plane 0 overwriting acc where !accumulate. Tile t is plane wg BZ / 2 +
  // t / kTilesX, columns 8 (t % kTilesX) ..; tap (kd, kh, kw) shifts it by
  // kd planes, kh rows and kw words. One straight line of 9 MT wgmma (see
  // conv_mma.cuh's mma_plane).
  template <int KD>
  __device__ static void products(Acc& acc, uint32_t st_addr, int wg,
                                  int accumulate) {
    const uint64_t da =
        mma::desc_at(mma::desc_strides(kWin * mma::kWord, WX * mma::kWord),
                     st_addr) +
        wg * (BZ / 2) * WY * WX;
    const uint64_t db = mma::desc_at(
        mma::desc_strides(NC * mma::kWord, 8 * mma::kWord),
        st_addr + kAWords * mma::kWord);
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        // a tap's weights: [2][NC][8] bf16, 2 NC words
        const uint64_t b = db + ((KD * 3 + kh) * 3 + kw) * 2 * NC;
#pragma unroll
        for (int t = 0; t < MT; ++t)
          wgmma(acc[t],
                da + ((t / kTilesX + KD) * WY + kh) * WX + 8 * (t % kTilesX) +
                    kw,
                b, KD + kh + kw > 0 || accumulate);
      }
  }

  // accumulator i of tile t: row 16 warp + lane / 4 + 8 ((i >> 1) & 1) of
  // the 8 x 8 patch, channel 8 (i >> 2) + 2 (lane & 3) + (i & 1)
  // NC 48 writes the box into the step's stage once every warpgroup's
  // products are done, then stores it after a barrier.
  __device__ void epilogue(Acc& acc, int u, uint4* out_tile, int tid,
                           int wg, int warp, int lane) const {
    const Unit g = unit(u);
    const int64_t out0 = (static_cast<int64_t>(g.n) * p.co + g.nc * NC) * vol;
    if (kStagedOut && p.split == 1) {
      unsigned short* tile = reinterpret_cast<unsigned short*>(out_tile);
      __syncthreads();
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const int pz = wg * (BZ / 2) + t / kTilesX;
        const int px = 8 * (t % kTilesX) + (lane >> 2);
#pragma unroll
        for (int i = 0; i < NC / 2; ++i) {
          const int py = 2 * warp + ((i >> 1) & 1);
          const int ch = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          tile[ch * kOutPitch + (pz * 8 + py) * BX + px] =
              __bfloat16_as_ushort(__float2bfloat16(acc[t][i]));
        }
      }
      __syncthreads();
      constexpr int kVecsX = BX / 8;
      for (int v = tid; v < NC * BZ * 8 * kVecsX; v += kThreads) {
        const int vx = v % kVecsX;
        const int r = v / kVecsX;                    // (ch, pz, py)
        const int py = r % 8;
        const int pz = r / 8 % BZ;
        const int ch = r / (8 * BZ);
        const int gz = g.z0 + pz, gy = g.y0 + py, gx = g.x0 + 8 * vx;
        if (gz >= p.D || gy >= p.H || gx >= p.W) continue;
        const unsigned short* src =
            tile + ch * kOutPitch + (pz * 8 + py) * BX + 8 * vx;
        __nv_bfloat16* dst = p.y + out0 + ch * vol +
                             (static_cast<int64_t>(gz) * p.H + gy) * p.W + gx;
        if (VEC && gx + 8 <= p.W) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          for (int k = 0; k < 8 && gx + k < p.W; ++k)
            dst[k] = __ushort_as_bfloat16(src[k]);
        }
      }
      return;
    }
    float* pn = p.part + static_cast<int64_t>(g.s) * p.N * p.co * vol;
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const int gz = g.z0 + wg * (BZ / 2) + t / kTilesX;
      const int gx = g.x0 + 8 * (t % kTilesX) + (lane >> 2);
      if (gz >= p.D || gx >= p.W) continue;
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) {
        const int gy = g.y0 + 2 * warp + ((i >> 1) & 1);
        const int ch = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (gy >= p.H) continue;
        const int64_t o = out0 + ch * vol +
                          (static_cast<int64_t>(gz) * p.H + gy) * p.W + gx;
        if (p.split == 1)
          p.y[o] = __float2bfloat16(acc[t][i]);
        else
          pn[o] = acc[t][i];
      }
    }
  }
};

// The skeleton. CTA b takes units b, b + gridDim.x, ... (persistent, one CTA
// an SM); step k is chunk k % chunks of its (k / chunks)-th unit, in stage
// k % 2. A step starts the next step's first halo loads (into registers),
// issues plane 0's products and waits with wgmma.wait_group 1 and a
// barrier until step k - 1's are done, so the other stage is free; then it
// stages the next step there, cut between the planes: the weights'
// cp.async, plane 1, the first half's stores and the second half's loads,
// plane 2, the second half's stores. After a unit's last step its
// epilogue; then the barrier that makes the next stage visible. The last
// step stages itself again (unread), so that no branch breaks the wgmma
// chain.
template <class B>
__global__ void __launch_bounds__(kThreads, 1) rconv_kernel(Conv p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint4* sm = reinterpret_cast<uint4*>(smem_raw);
  const B body(p);
  const int step_units = gridDim.x;
  if (static_cast<int>(blockIdx.x) >= body.total) return;
  const int units = (body.total - 1 - blockIdx.x) / step_units + 1;
  const int steps = units * body.chunks;
  constexpr int words = B::kStage;
  const int tid = threadIdx.x;
  const int wg = tid / mma::kWarpgroup;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const uint32_t sm_addr = mma::smem_addr(sm);
  auto unit_of = [&](int k) {
    return blockIdx.x + k / body.chunks * step_units;
  };

  typename B::Regs regs;
  body.weights(unit_of(0), 0, sm, tid);
  body.template load<0>(regs, unit_of(0), 0, tid);
  body.template store<0>(regs, unit_of(0), 0, sm, tid);
  body.template load<1>(regs, unit_of(0), 0, tid);
  body.template store<1>(regs, unit_of(0), 0, sm, tid);
  cp_async_wait();
  mma::proxy_fence();
  __syncthreads();

  typename B::Acc acc;
  for (int k = 0; k < steps; ++k) {
    const int s = k & 1;
    const int c = k % body.chunks;
    const uint32_t st_addr = sm_addr + s * words * mma::kWord;
    const int kn = min(k + 1, steps - 1);
    uint4* next = sm + (s ^ 1) * words;
    const int un = unit_of(kn), cn = kn % body.chunks;
    body.template load<0>(regs, un, cn, tid);
    mma::fence();
    body.template products<0>(acc, st_addr, wg, c > 0);
    mma::commit();
    wait_one();
    __syncthreads();
    body.weights(un, cn, next, tid);
    body.template products<1>(acc, st_addr, wg, 1);
    mma::commit();
    body.template store<0>(regs, un, cn, next, tid);
    body.template load<1>(regs, un, cn, tid);
    body.template products<2>(acc, st_addr, wg, 1);
    mma::commit();
    body.template store<1>(regs, un, cn, next, tid);
    if (c + 1 == body.chunks) {
      mma::wait_all();
      B::fence(acc);
      body.epilogue(acc, unit_of(k), sm + s * words, tid, wg, warp, lane);
    }
    cp_async_wait();
    mma::proxy_fence();
    __syncthreads();
  }
}

// y[i] = bf16(part[0][i] + part[1][i] + ... + part[split - 1][i]), in that
// order, for i < count.
__global__ void rconv_reduce_kernel(const float* __restrict__ part,
                                    __nv_bfloat16* __restrict__ y,
                                    int64_t count, int split) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < count; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float acc = part[i];
    for (int k = 1; k < split; ++k) acc += part[k * count + i];
    y[i] = __float2bfloat16(acc);
  }
}

template <int NC, bool VEC>
int launch(const Conv& p, int ctas, cudaStream_t stream) {
  using B = BoxBody<NC, VEC>;
  static_assert(B::kSmem <= mma::kMaxSmem, "two stages in shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      rconv_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize, B::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rconv_kernel<B><<<ctas, kThreads, B::kSmem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.split == 1) return static_cast<int>(err);
  const int64_t count = static_cast<int64_t>(p.N) * p.co * p.D * p.H * p.W;
  const int64_t blocks = (count + 255) / 256;
  rconv_reduce_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256,
                        0, stream>>>(p.part, p.y, count, p.split);
  return static_cast<int>(cudaGetLastError());
}

// wp[j][c][t][g][o][k] = bf16(w[nc j + o][16 c + 8 g + k][t]) from the
// module's float32 (co, ci, 27) weights, one pass: a CTA takes depth chunk
// c of 16 output channels, reads their 16 rows of 16 x 27 contiguous
// floats, rounds them into shared memory (rows padded to an odd number of
// words) and writes its 54 runs of 16 words.
constexpr int kPackRow = kKC * 27;
constexpr int kPackPitch = kPackRow + 2;
constexpr int kPackThreads = 128;

__global__ void __launch_bounds__(kPackThreads)
rconv_pack_kernel(const float* __restrict__ w, __nv_bfloat16* __restrict__ wp,
                  int ci, int nc) {
  __shared__ unsigned short tile[16 * kPackPitch];
  const int c = blockIdx.x;
  const int o0 = 16 * blockIdx.y;
  // a row is 108 aligned float4 (ci a multiple of 16); every load of the
  // thread in flight before the first store
  constexpr int kVec = 16 * kPackRow / 4;
  constexpr int kLoads = (kVec + kPackThreads - 1) / kPackThreads;
  float4 v[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = threadIdx.x + k * kPackThreads;
    const int o = i / (kPackRow / 4);
    if (i < kVec)
      v[k] = __ldg(reinterpret_cast<const float4*>(
                       w + (static_cast<int64_t>(o0 + o) * ci + kKC * c) *
                               27) +
                   i - o * (kPackRow / 4));
  }
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = threadIdx.x + k * kPackThreads;
    if (i >= kVec) break;
    const int o = i / (kPackRow / 4);
    uint32_t* t = reinterpret_cast<uint32_t*>(
        tile + o * kPackPitch + 4 * (i - o * (kPackRow / 4)));
    t[0] = mma::pack_pair(v[k].x, v[k].y);
    t[1] = mma::pack_pair(v[k].z, v[k].w);
  }
  __syncthreads();
  uint4* out = reinterpret_cast<uint4*>(wp) +
               (static_cast<int64_t>(o0 / nc) * (ci / kKC) + c) * 54 * nc +
               o0 % nc;
  for (int i = threadIdx.x; i < 54 * 16; i += kPackThreads) {
    const int o = i % 16;
    const int tg = i / 16;                 // t * 2 + g
    // channel 8 g + k of tap t: row entry (8 g + k) * 27 + t
    const unsigned short* src =
        tile + o * kPackPitch + 8 * (tg & 1) * 27 + (tg >> 1);
    uint4 word;
    word.x = src[0] | (static_cast<uint32_t>(src[27]) << 16);
    word.y = src[54] | (static_cast<uint32_t>(src[81]) << 16);
    word.z = src[108] | (static_cast<uint32_t>(src[135]) << 16);
    word.w = src[162] | (static_cast<uint32_t>(src[189]) << 16);
    out[tg * nc + o] = word;
  }
}

// ---- ci = 1 on the CUDA cores ---------------------------------------------

constexpr int k1TX = 32;                 // columns a CTA: one a lane
constexpr int k1TY = 16;                 // rows a CTA, marched
constexpr int k1TZ = 4;                  // planes a CTA
constexpr int k1Chan = 4;                // output channels a warp
constexpr int k1MaxCo = 48;              // 12 warps

__global__ void __launch_bounds__(32 * k1MaxCo / k1Chan, 1)
rconv_ci1_kernel(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ w, __nv_bfloat16* __restrict__ y,
                 int co, int D, int H, int W, int tiles_x, int tiles_y) {
  __shared__ float xs[k1TZ + 2][k1TY + 2][k1TX + 2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int c0 = k1Chan * (tid >> 5);
  const int x0 = (blockIdx.x % tiles_x) * k1TX;
  const int y0 = (blockIdx.x / tiles_x % tiles_y) * k1TY;
  const int z0 = blockIdx.y * k1TZ;
  const int n = blockIdx.z;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t vol = D * plane;
  const unsigned short* xn =
      reinterpret_cast<const unsigned short*>(x) + n * vol;

  constexpr int kHalo = (k1TZ + 2) * (k1TY + 2) * (k1TX + 2);
  for (int i = tid; i < kHalo; i += blockDim.x) {
    const int col = i % (k1TX + 2);
    const int row = i / (k1TX + 2) % (k1TY + 2);
    const int pz = i / ((k1TX + 2) * (k1TY + 2));
    const int gz = z0 - 1 + pz, gy = y0 - 1 + row, gx = x0 - 1 + col;
    float v = 0.f;
    if (gz >= 0 && gz < D && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = __uint_as_float(static_cast<uint32_t>(
                              __ldg(xn + gz * plane +
                                    static_cast<int64_t>(gy) * W + gx))
                          << 16);
    (&xs[0][0][0])[i] = v;
  }
  float wr[27][k1Chan];   // the bf16 weights, widened
#pragma unroll
  for (int t = 0; t < 27; ++t)
#pragma unroll
    for (int k = 0; k < k1Chan; ++k)
      wr[t][k] =
          __bfloat162float(__float2bfloat16(__ldg(w + (c0 + k) * 27 + t)));
  __syncthreads();

  const int gx = x0 + lane;
  for (int pz = 0; pz < k1TZ; ++pz) {
    const int gz = z0 + pz;
    if (gz >= D) break;
    float win[3][3][3];   // [kd][kh][kw] for the current row
#pragma unroll
    for (int kd = 0; kd < 3; ++kd)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
          win[kd][kh + 1][kw] = xs[pz + kd][kh][lane + kw];
#pragma unroll 2
    for (int r = 0; r < k1TY; ++r) {
#pragma unroll
      for (int kd = 0; kd < 3; ++kd)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          win[kd][0][kw] = win[kd][1][kw];
          win[kd][1][kw] = win[kd][2][kw];
          win[kd][2][kw] = xs[pz + kd][r + 2][lane + kw];
        }
      float acc[k1Chan] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kd = 0; kd < 3; ++kd)
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
#pragma unroll
            for (int k = 0; k < k1Chan; ++k)
              acc[k] = fmaf(win[kd][kh][kw], wr[(kd * 3 + kh) * 3 + kw][k],
                            acc[k]);
      const int gy = y0 + r;
      if (gy < H && gx < W) {
#pragma unroll
        for (int k = 0; k < k1Chan; ++k)
          y[(static_cast<int64_t>(n) * co + c0 + k) * vol + gz * plane +
            static_cast<int64_t>(gy) * W + gx] = __float2bfloat16(acc[k]);
      }
    }
  }
}

}  // namespace
}  // namespace tpuseg

// wp = the packed weights [co / nc][ci / 16][27][2][nc][8] bf16 of w, the
// module's (co, ci, 3, 3, 3) float32 weights, contiguous; ci a multiple of
// 16, co of nc, nc 48 or 96.
extern "C" int tpuseg_rconv_pack(const void* w, void* wp, int ci, int co,
                                 int nc, void* stream) {
  using namespace tpuseg;
  if (ci % kKC != 0 || (nc != 48 && nc != 96) || co % nc != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  rconv_pack_kernel<<<dim3(ci / kKC, co / 16), kPackThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<__nv_bfloat16*>(wp), ci, nc);
  return static_cast<int>(cudaGetLastError());
}

// y = conv3x3x3_SAME(x, w), bias-free, bf16, NCDHW, contiguous: x (N, ci,
// D, H, W), y (N, co, D, H, W); wp: the weights as tpuseg_rconv_pack packs
// them; ci a multiple of 16, co of nc, (ci / 16) of split; part: split * N
// * co * D * H * W float32 where split > 1 (else unused); ctas persistent
// CTAs, one an SM at most (ops/rconv.py's rconv_plan); nc, the box body's N
// tile: 48 or 96.
extern "C" int tpuseg_rconv(const void* x, const void* wp, void* y,
                            void* part, int N, int ci, int co, int D, int H,
                            int W, int nc, int split, int ctas,
                            void* stream) {
  using namespace tpuseg;
  if (ci % kKC != 0 || split < 1 || (ci / kKC) % split != 0 ||
      (nc != 48 && nc != 96) || co % nc != 0 || ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Conv p{static_cast<const __nv_bfloat16*>(x),
               static_cast<const __nv_bfloat16*>(wp),
               static_cast<__nv_bfloat16*>(y), static_cast<float*>(part),
               N, ci, co, D, H, W, split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte vectors: W a multiple of 8 and x 16-byte aligned
  const bool vec = W % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (nc == 48)
    return vec ? launch<48, true>(p, ctas, s) : launch<48, false>(p, ctas, s);
  return vec ? launch<96, true>(p, ctas, s) : launch<96, false>(p, ctas, s);
}

// The same function for ci = 1: w the module's (co, 1, 3, 3, 3) float32
// weights, contiguous, rounded to bf16 in the kernel; co a multiple of 4 up
// to 48; x, y as above. The wrapper checks ceil(D / 4), N <= 65535.
extern "C" int tpuseg_rconv_ci1(const void* x, const void* w, void* y, int N,
                                int co, int D, int H, int W, void* stream) {
  using namespace tpuseg;
  if (co % k1Chan != 0 || co > k1MaxCo || co < k1Chan)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (W + k1TX - 1) / k1TX;
  const int tiles_y = (H + k1TY - 1) / k1TY;
  const dim3 grid(tiles_x * tiles_y, (D + k1TZ - 1) / k1TZ, N);
  rconv_ci1_kernel<<<grid, 32 * (co / k1Chan), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<__nv_bfloat16*>(y), co, D, H, W, tiles_x, tiles_y);
  return static_cast<int>(cudaGetLastError());
}
