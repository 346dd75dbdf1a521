// Fused shifted-window attention of SwinUNETR's Swin blocks (W1; no Pallas
// counterpart: the reference net is not in tpuseg).
//
// For every (window, head) of a block's padded, rolled and partitioned token
// grid it computes
//
//   o = softmax(q k^T * scale + B[rel(i, j)] + M(i, j)) v
//
// from the qkv linear's output as it lies, (B*nW, N, 3, heads, 16) bf16, and
// writes (B*nW, N, heads*16) bf16 for the proj linear. B is the learned
// (13^3, heads) float32 table of relative positions, indexed by
// ((dz + 6) * 13 + dy + 6) * 13 + dx + 6 with the window's own coordinates
// (a shrunk window's too); M is -100 between tokens of different shift
// regions (a shifted block's region ids, from the token's place in the
// rolled, padded grid, as Swin's mask) and 0 otherwise. No tensor of
// windows x N^2 exists anywhere: the bias and the mask are computed per
// score from the table and the tokens' coordinates.
//
// One CTA per (window, head), 8 warps. The window's K rows (48-byte rows:
// conflict-free B fragments), V transposed (a padded stride: conflict-free),
// the head's table column and every token's code (coordinates and region)
// are staged in shared memory once; each warp takes 16 query rows at a time.
// q k^T is one mma.sync m16n8k16 a key octet (k = head dim = 16); the scores
// stay in float32 registers, softmax is online over 64-key tiles, P is
// rounded to bf16 and multiplies V on mma.sync, its accumulator kept in
// float32 and divided by the row sum at the end, as flash attention does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace tpuseg {
namespace {

constexpr int kHd = 16;                       // head dim
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKeyTile = 64;
constexpr int kSide = 13;                     // 2 * 7 - 1
constexpr int kTable = kSide * kSide * kSide;
constexpr int kCentre = (6 * kSide + 6) * kSide + 6;
constexpr int kKStride = 24;                  // bf16 a staged K row
constexpr int kMaxTokens = 384;               // keeps shared memory < 48 KB
constexpr float kMaskValue = -100.0f;
constexpr float kLog2e = 1.4426950408889634f;

struct Geom {
  int N, heads;
  int nwd, nwh, nww;      // windows along each axis
  int wd, wh, ww;         // window extent
  int sd, sh, sw;         // shift (0: that axis unshifted)
};

__host__ __device__ inline int key_pad(int n) {
  return (n + kKeyTile - 1) / kKeyTile * kKeyTile;
}

__host__ __device__ inline int smem_bytes(int kp) {
  return kp * kKStride * 2 + kHd * (kp + 8) * 2 + kTable * 4 + kp * 4;
}

// Swin's shift region along one axis of the rolled, padded grid: the
// windows' last w - s and last s positions hold tokens rolled in from
// elsewhere; an unshifted axis is one region.
__device__ __forceinline__ int region(int c, int len, int w, int s) {
  if (s == 0) return 0;
  return c < len - w ? 0 : (c < len - s ? 1 : 2);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads)
window_attn_kernel(const __nv_bfloat16* __restrict__ qkv,
                   const float* __restrict__ table,
                   __nv_bfloat16* __restrict__ out, Geom g, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = g.N, kp = key_pad(N), vstride = kp + 8;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vt = ks + kp * kKStride;
  float* tab = reinterpret_cast<float*>(vt + kHd * vstride);
  int* code = reinterpret_cast<int*>(tab + kTable);

  const int bw = blockIdx.x, h = blockIdx.y;
  const int row_len = 3 * g.heads * kHd;            // a token's qkv elements
  const int wl = bw % (g.nwd * g.nwh * g.nww);
  const int wz = wl / (g.nwh * g.nww), wy = (wl / g.nww) % g.nwh,
            wx = wl % g.nww;
  const __nv_bfloat16* base = qkv + static_cast<size_t>(bw) * N * row_len +
                              h * kHd;

  // stage K (rows), V (transposed), zero past N
  for (int i = threadIdx.x; i < kp * 2; i += kThreads) {
    const int n = i >> 1, part = i & 1;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (n < N) {
      const __nv_bfloat16* row = base + static_cast<size_t>(n) * row_len +
                                 part * 8;
      kv = *reinterpret_cast<const uint4*>(row + g.heads * kHd);
      vv = *reinterpret_cast<const uint4*>(row + 2 * g.heads * kHd);
    }
    *reinterpret_cast<uint4*>(ks + n * kKStride + part * 8) = kv;
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
    for (int d = 0; d < 8; ++d) vt[(part * 8 + d) * vstride + n] = ve[d];
  }
  for (int i = threadIdx.x; i < kTable; i += kThreads)
    tab[i] = table[i * g.heads + h];
  // a token's code: its window coordinates in base 13, its region above
  for (int n = threadIdx.x; n < kp; n += kThreads) {
    const int m = n < N ? n : N - 1;
    const int z = m / (g.wh * g.ww), y = (m / g.ww) % g.wh, x = m % g.ww;
    const int r =
        (region(wz * g.wd + z, g.nwd * g.wd, g.wd, g.sd) * 3 +
         region(wy * g.wh + y, g.nwh * g.wh, g.wh, g.sh)) * 3 +
        region(wx * g.ww + x, g.nww * g.ww, g.ww, g.sw);
    code[n] = ((z * kSide + y) * kSide + x) | (r << 16);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, qq = lane & 3;
  const int row_tiles = (N + 15) / 16, key_tiles = kp / kKeyTile;
  for (int rt = warp; rt < row_tiles; rt += kWarps) {
    const int r0 = rt * 16 + gq, r1 = r0 + 8;
    auto qword = [&](int r, int col) -> uint32_t {
      return r < N ? *reinterpret_cast<const uint32_t*>(
                         base + static_cast<size_t>(r) * row_len + col)
                   : 0u;
    };
    const uint32_t qa[4] = {qword(r0, 2 * qq), qword(r1, 2 * qq),
                            qword(r0, 2 * qq + 8), qword(r1, 2 * qq + 8)};
    const int c0 = code[r0], c1 = code[r1];
    const int p0 = (c0 & 0xffff) + kCentre, p1 = (c1 & 0xffff) + kCentre;
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
    float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kt = 0; kt < key_tiles; ++kt) {
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        const __nv_bfloat16* krow =
            ks + (kt * kKeyTile + j * 8 + gq) * kKStride + 2 * qq;
        mma_bf16(s[j], qa, *reinterpret_cast<const uint32_t*>(krow),
                 *reinterpret_cast<const uint32_t*>(krow + 8));
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kt * kKeyTile + j * 8 + 2 * qq + e;
          float v0 = -CUDART_INF_F, v1 = -CUDART_INF_F;
          if (col < N) {
            const int cj = code[col];
            v0 = s[j][e] * scale + tab[p0 - (cj & 0xffff)];
            v1 = s[j][2 + e] * scale + tab[p1 - (cj & 0xffff)];
            if ((c0 ^ cj) >> 16) v0 += kMaskValue;
            if ((c1 ^ cj) >> 16) v1 += kMaskValue;
          }
          s[j][e] = v0;
          s[j][2 + e] = v1;
          mx0 = fmaxf(mx0, v0);
          mx1 = fmaxf(mx1, v1);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // every key tile holds a key < N, so the maxima are finite
      const float a0 = exp2f((m0 - mx0) * kLog2e);
      const float a1 = exp2f((m1 - mx1) * kLog2e);
      m0 = mx0;
      m1 = mx1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        o[d][0] *= a0;
        o[d][1] *= a0;
        o[d][2] *= a1;
        o[d][3] *= a1;
      }
      // P as the A fragments of four k16 steps: key octet j is step j / 2,
      // its low or high half by j % 2
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e0 = exp2f((s[j][0] - m0) * kLog2e);
        const float e1 = exp2f((s[j][1] - m0) * kLog2e);
        const float e2 = exp2f((s[j][2] - m1) * kLog2e);
        const float e3 = exp2f((s[j][3] - m1) * kLog2e);
        l0 += e0 + e1;
        l1 += e2 + e3;
        pa[j >> 1][(j & 1) * 2] = pack_bf16(e0, e1);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(e2, e3);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int key = kt * kKeyTile + t * 16 + 2 * qq;
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const __nv_bfloat16* vrow = vt + (d * 8 + gq) * vstride + key;
          mma_bf16(o[d], pa[t], *reinterpret_cast<const uint32_t*>(vrow),
                   *reinterpret_cast<const uint32_t*>(vrow + 8));
        }
      }
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    const size_t out_row = static_cast<size_t>(g.heads) * kHd;
    __nv_bfloat16* dst =
        out + static_cast<size_t>(bw) * N * out_row + h * kHd + 2 * qq;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      if (r0 < N)
        *reinterpret_cast<uint32_t*>(dst + r0 * out_row + d * 8) =
            pack_bf16(o[d][0] * i0, o[d][1] * i0);
      if (r1 < N)
        *reinterpret_cast<uint32_t*>(dst + r1 * out_row + d * 8) =
            pack_bf16(o[d][2] * i1, o[d][3] * i1);
    }
  }
}

}  // namespace
}  // namespace tpuseg

// qkv (B*nW, N, 3, heads, 16) bf16, table (13^3, heads) float32, out
// (B*nW, N, heads*16) bf16; windows = B*nW, nW = nwd*nwh*nww, N = wd*wh*ww.
extern "C" int tpuseg_window_attention(const void* qkv, const void* table,
                                       void* out, int windows, int heads,
                                       int nwd, int nwh, int nww, int wd,
                                       int wh, int ww, int sd, int sh, int sw,
                                       float scale, void* stream) {
  using namespace tpuseg;
  const int N = wd * wh * ww, nw = nwd * nwh * nww;
  if (N < 1 || N > kMaxTokens || heads < 1 || heads > 65535 || nw < 1 ||
      windows % nw != 0 || wd > 7 || wh > 7 || ww > 7 || sd >= wd ||
      sh >= wh || sw >= ww || sd < 0 || sh < 0 || sw < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (windows == 0) return 0;
  const Geom g{N, heads, nwd, nwh, nww, wd, wh, ww, sd, sh, sw};
  window_attn_kernel<<<dim3(windows, heads), kThreads,
                       smem_bytes(key_pad(N)),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(table), static_cast<__nv_bfloat16*>(out), g,
      scale);
  return static_cast<int>(cudaGetLastError());
}
