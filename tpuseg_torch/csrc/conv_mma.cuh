// The tensor-core mainloop shared by the training conv (K6, convtrain.cu;
// replaces tpuseg/ops/pallas_convtrain.py:flat_conv3x3) and the fused eval
// ConvBlock (K4, convblock.cu; replaces
// tpuseg/ops/pallas_convblock.py:fused_convblock_chw): a 3x3x3 SAME
// convolution in bf16 as an implicit GEMM on Hopper's warpgroup MMA.
//
//   rows    M = output voxels, 64 to a tile
//   columns N = output channels (32, or 64)
//   depth   K = 27 taps x ci: per tap one (64 x ci) x (ci x N) product whose
//               A operand is the activation tile shifted by the tap
//
// run as wgmma.mma_async.sync.aligned.m64n{32,64}k16.f32.bf16.bf16, both
// operands read from shared memory through matrix descriptors, the sum kept
// in float32 registers and rounded once by the caller.
//
// The layout, and why. NCDHW has x contiguous and the channel (the GEMM's
// depth) strided by D*H*W, and a tap shifts the tile by one voxel in x: 2
// bytes in that layout, where a descriptor's start address must be a
// multiple of 16. So activations are staged in shared memory as
//
//   [ci / 8][position][8 channels]   bf16, 16 bytes a position
//
// (descriptor layout type 0, INTERLEAVE, no swizzle): one voxel's 8 channels
// are one 16-byte word, and 8 neighbouring positions are one contiguous
// 128-byte core matrix (8 rows of M x 8 of K). A shift by one voxel in x is
// then 16 bytes, a shift in y one row pitch, a shift in z one plane, all
// legal start addresses, and one staged copy serves all 27 taps. The
// descriptor's leading byte offset is the stride between channel groups of 8
// (the K direction), its stride byte offset the stride between the 8
// core-matrix rows of a 64-row tile (the M direction): the row pitch of a
// halo tile for an (8 rows x 8 columns) tile, or 128 bytes for 64
// consecutive positions of a flattened (row x pitch) plane. Both forms and
// the 16-byte shifts were checked against a scalar product on the card. The
// alternative, an x-contiguous tile as an M-major operand, needs three
// copies pre-shifted in x (3x the shared memory) because its start address
// cannot move by 2 bytes. The re-lay happens while staging (VecStage): a
// thread reads 16 bytes (8 x) of each of a group's 8 channels, transposes
// 8 x 8 in registers and writes eight 16-byte words; a tensor whose rows are
// not 16-byte aligned takes 2-byte loads instead. (TMA cannot interleave
// channels out of NCDHW.)
//
// Weights are packed by the Python wrapper (ops/conv_mma.py) as
// [27 taps][ci / 8][co][8 channels] bf16: per tap a K-major B operand with
// leading byte offset co * 16 and stride byte offset 128. They are copied
// into shared memory once per CTA and stay there.
//
// What bounds it: operations, fed from shared memory. An m64n32k16 reads
// 2 KB of A and 1 KB of B for 32 K multiply-adds; at 128 bytes a clock that
// is 24 clocks against 16 on the tensor cores, so N = 32 from shared memory
// tops out near two thirds of the tensor rate (N = 64: 32 against 32).
//
// The accumulator of an m64nN tile: thread t of the warpgroup (warp w = t/32,
// lane l) holds d[4j + e] = D[row 16w + l/4 + 8(e/2)][column 8j + 2(l%4) +
// e%2], j < N/8: pairs of neighbouring channels of one voxel, so four lanes
// fill one 16-byte word of the interleaved layout (pack_pair).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tpuseg {
namespace mma {

constexpr int kWord = 16;        // bytes of one position's 8 channels
constexpr int kWarpgroup = 128;  // threads that run one wgmma together
constexpr int kMaxSmem = 232448; // bytes of shared memory a block can opt in to

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The descriptor's stride fields (layout type 0): leading byte offset = the
// K direction, stride byte offset = the M / N direction, in 16-byte units.
__device__ __forceinline__ uint64_t desc_strides(uint32_t lbo, uint32_t sbo) {
  return (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}
__device__ __forceinline__ uint64_t desc_at(uint64_t strides, uint32_t addr) {
  return strides | static_cast<uint64_t>((addr >> 4) & 0x3FFF);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory (st.shared) become visible to the
// async proxy, which is where wgmma reads its operands. Every writing thread
// executes it before the barrier that precedes the wgmma.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accesses to the accumulators across the
// asynchronous instructions that write them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A * B for one 64 x N x 16 step.
__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db));
}
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// The 9 taps of one z plane for MT 64-row tiles:
//
//   acc[t] += sum_{kh, kw, c} A_t[m][kh, kw, c] * w[kh*3 + kw][c][o]
//
// a_addr: shared address of tile 0's first position at tap (kh, kw) = (0, 0),
// channel group 0; a_tile: bytes from one tile to the next; a_row: bytes of
// one step in kh (a step in kw is one 16-byte word); a_lbo / a_sbo: the
// descriptor's K and M strides in bytes; w_addr: shared address of this
// plane's first tap and channel; w_tap: bytes from one tap's (ci x CO) slice
// to the next; KSTEPS: 16-channel steps to run (ci / 16, or fewer where the
// caller feeds the channels in pieces). Starts 9 * KSTEPS * MT asynchronous
// wgmma; the caller fences before and commits and waits after. All threads
// of the warpgroup pass the same values. KSTEPS is a template parameter so
// that the products are one straight line of code: around a loop whose trip
// count it cannot see, ptxas puts a warpgroup.arrive at every entry (C7519),
// 27 fences a plane in place of one.
template <int CO, int MT, int KSTEPS>
__device__ __forceinline__ void mma_plane(float (&acc)[MT][CO / 2],
                                          uint32_t a_addr, uint32_t a_tile,
                                          uint32_t a_row, uint32_t a_lbo,
                                          uint32_t a_sbo, uint32_t w_addr,
                                          uint32_t w_tap) {
  const uint64_t a_strides = desc_strides(a_lbo, a_sbo);
  const uint64_t b_strides = desc_strides(CO * kWord, 8 * kWord);
  const uint32_t w_kstep = 2 * CO * kWord;
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const uint32_t a_tap = a_addr + kh * a_row + kw * kWord;
      const uint32_t b_tap = w_addr + (kh * 3 + kw) * w_tap;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const uint64_t db = desc_at(b_strides, b_tap + ks * w_kstep);
#pragma unroll
        for (int t = 0; t < MT; ++t)
          wgmma(acc[t],
                desc_at(a_strides, a_tap + t * a_tile + ks * 2 * a_lbo), db);
      }
    }
  }
}

// dst[i] <- src[i] for n 16-byte words of packed weights (device memory,
// 16-byte aligned) into shared memory, by all THREADS threads of the CTA.
template <int THREADS>
__device__ __forceinline__ void copy_words(uint4* dst, const void* src,
                                           int n) {
  const uint4* s = static_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = __ldg(s + i);
}

// Stage one (ROWS x COLS) window of one z plane of an NCDHW bf16 tensor into
// the interleaved layout, zero outside the volume:
//
//   dst[g * group_words + row * COLS + col] <- the 8 channels c0 + 8g .. + 7
//   of xn[:, gz, gy0 + row, gx0 + col],   g < groups
//
// xn points at the sample's channel 0; by tid of THREADS threads. Two ways,
// picked by what the tensor allows (vec_ok):
//
// * VecStage, for W a multiple of 8 and a 16-byte aligned xn: a unit is
//   (channel group, row, aligned vector of 8 x). A thread loads the vector of
//   each of the 8 channels (16 bytes each), transposes the 8 x 8 values in
//   registers (one byte permute per channel pair and position) and stores up
//   to eight 16-byte words, those that fall into the window. A vector is
//   wholly inside or outside the volume. Consecutive lanes take the vectors
//   of one row, then the next row, so a warp's load touches a cache line or
//   two per row. load() and store() are separate calls: the kernels start
//   the loads of the window after next, keep them in flight in registers
//   across a whole step of products, and store them one step later, which
//   hides the loads' latency (a window is at most kBatch units a thread).
// * stage_plane_scalar, for any W: a unit is one position; eight 2-byte
//   loads, one per channel and coalesced along x over the warp, are packed
//   into one 16-byte store. The loads of kBatch units are started before the
//   first store.
__device__ __forceinline__ bool vec_ok(const __nv_bfloat16* xn, int W) {
  return W % 8 == 0 && (reinterpret_cast<uintptr_t>(xn) & 15) == 0;
}

template <int THREADS, int ROWS, int COLS>
struct VecStage {
  static constexpr int kBatch = 2;
  // units of a window of `groups` channel groups, at most
  __host__ __device__ static constexpr int max_units(int groups) {
    return groups * ROWS * ((COLS + 14) / 8);
  }
  uint32_t v[kBatch][8][4];

  __device__ __forceinline__ void load(const __nv_bfloat16* xn, int c0,
                                       int groups, int gz, int gy0, int gx0,
                                       int D, int H, int W, int tid) {
    const int v0 = gx0 >> 3;              // the window's first vector (floor)
    const int nv = ((gx0 + COLS - 1) >> 3) - v0 + 1;  // vectors a row touches
    const int per_group = nv * ROWS;
    const int total = groups * per_group;
    const int64_t plane = static_cast<int64_t>(H) * W;
    const int64_t chan = static_cast<int64_t>(D) * plane / 8;  // in vectors
    const bool z_in = gz >= 0 && gz < D;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int u = tid + i * THREADS;
      const int g = u / per_group;
      const int row = (u - g * per_group) / nv;
      const int gy = gy0 + row;
      const int vx = 8 * (v0 + u - g * per_group - row * nv);
      const bool in = u < total && z_in && gy >= 0 && gy < H && vx >= 0 &&
                      vx < W;
      const uint4* p = reinterpret_cast<const uint4*>(
          xn + (static_cast<int64_t>(c0 + 8 * g) * D + gz) * plane +
          static_cast<int64_t>(gy) * W + vx);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint4 r = in ? __ldg(p + k * chan) : make_uint4(0u, 0u, 0u, 0u);
        v[i][k][0] = r.x;
        v[i][k][1] = r.y;
        v[i][k][2] = r.z;
        v[i][k][3] = r.w;
      }
    }
  }

  // The window that load() was given, with the same groups, gx0 and tid.
  __device__ __forceinline__ void store(uint4* dst, int group_words,
                                        int groups, int gx0, int tid) const {
    const int v0 = gx0 >> 3;
    const int nv = ((gx0 + COLS - 1) >> 3) - v0 + 1;
    const int per_group = nv * ROWS;
    const int total = groups * per_group;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int u = tid + i * THREADS;
      if (u >= total) break;
      const int g = u / per_group;
      const int r = (u - g * per_group) / nv;
      // window column of the vector's first position
      const int col0 = 8 * (v0 + u - g * per_group - r * nv) - gx0;
      uint4* row = dst + g * group_words + r * COLS;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // position j of the vector: the low (even j) or high (odd j) half of
        // register j / 2 of every channel
        const uint32_t sel = (j & 1) ? 0x7632 : 0x5410;
        uint4 word;
        word.x = __byte_perm(v[i][0][j >> 1], v[i][1][j >> 1], sel);
        word.y = __byte_perm(v[i][2][j >> 1], v[i][3][j >> 1], sel);
        word.z = __byte_perm(v[i][4][j >> 1], v[i][5][j >> 1], sel);
        word.w = __byte_perm(v[i][6][j >> 1], v[i][7][j >> 1], sel);
        if (col0 + j >= 0 && col0 + j < COLS) row[col0 + j] = word;
      }
    }
  }
};

template <int THREADS, int ROWS, int COLS>
__device__ __forceinline__ void stage_plane_scalar(uint4* dst, int group_words,
                                                   const __nv_bfloat16* xn,
                                                   int c0, int groups, int gz,
                                                   int gy0, int gx0, int D,
                                                   int H, int W, int tid) {
  constexpr int kBatch = 4;
  constexpr int kWindow = ROWS * COLS;
  const int total = groups * kWindow;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t chan = static_cast<int64_t>(D) * plane;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(xn);
  const bool z_in = gz >= 0 && gz < D;
  for (int u0 = tid; u0 < total; u0 += kBatch * THREADS) {
    unsigned short v[kBatch][8];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int u = u0 + i * THREADS;
      const int g = u / kWindow;
      const int pos = u - g * kWindow;
      const int row = pos / COLS;
      const int gy = gy0 + row;
      const int gx = gx0 + pos - row * COLS;
      const bool in = u < total && z_in && gy >= 0 && gy < H && gx >= 0 &&
                      gx < W;
      const unsigned short* p =
          src + (static_cast<int64_t>(c0 + 8 * g) * D + gz) * plane +
          static_cast<int64_t>(gy) * W + gx;
#pragma unroll
      for (int k = 0; k < 8; ++k) v[i][k] = in ? __ldg(p + k * chan) : 0;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int u = u0 + i * THREADS;
      if (u >= total) break;
      const int g = u / kWindow;
      uint4 word;
      word.x = v[i][0] | (static_cast<uint32_t>(v[i][1]) << 16);
      word.y = v[i][2] | (static_cast<uint32_t>(v[i][3]) << 16);
      word.z = v[i][4] | (static_cast<uint32_t>(v[i][5]) << 16);
      word.w = v[i][6] | (static_cast<uint32_t>(v[i][7]) << 16);
      dst[g * group_words + (u - g * kWindow)] = word;
    }
  }
}

// Two neighbouring channels as one bf16 pair, the lower channel in the low
// half (the order of the interleaved layout).
__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace mma
}  // namespace tpuseg
