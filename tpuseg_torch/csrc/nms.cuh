// Peak-NMS seeds, shared by the fused seed pass (seed.cu, K1) and the
// peak-NMS kernel (nms.cu, K5):
//
//   mx    = (2r+1)^3 max-pool of peak, -inf outside
//   cidx  = lin where peak >= thr and peak >= mx, else -1
//   midx  = (2r+1)^3 max-pool of cidx, -1 outside
//   seed  = cidx >= 0 and cidx == midx
//
// On an exact plateau only the candidate with the largest linear index
// survives. The index pool runs on int32: linear indices of a 96x512x512
// stack pass 2^24, where a float32 pool would merge neighbouring candidates.
//
// The dependency cone. A core voxel's seed status depends on cidx up to r
// away, and a cidx up to r away depends on peak up to 2r from the core. A
// window with a halo of r alone is wrong: a halo voxel on a plateau that
// crosses the window's edge would see -inf beyond it, call itself a
// candidate and suppress the true seed. So the halo is 2r.
//
// The tile pass (nms_tile_kernel): one launch, nothing between peak and the
// outputs in device memory. A block owns a (kTileY, kTileX) tile of (y, x)
// with a halo of 2r and marches over z, kTilePlanes planes a step. A thread
// owns one quad of four neighbouring x positions of the window for the whole
// march, so the two z windows live in its registers and planes move as
// 16-byte words. For each plane zi that comes in:
//
//   1. the window of peak[zi] arrives in shared memory (-inf outside the
//      volume, which equals skipping those entries) by cp.async, started one
//      step ahead into the other of two buffers: with one plane a step and a
//      plain load ahead of every barrier the pass was bound by the loads'
//      latency (0.58 ms over 96x512x512 with every pooling skipped, on an
//      NVIDIA H100 80GB HBM3 at 700.00 W);
//   2. pool it along x (a quad reads its two neighbours), then along y
//      (2 ry + 1 rows of quads): b, the 2-D pool at core + r, and the flag
//      e = (peak == b); push both into the thread's ring of 2 rz + 1 planes.
//      mx of plane zc = zi - rz is the ring's max, and a voxel of zc is a
//      candidate iff its flag is set and its b is >= thr and >= mx
//      (peak >= mx means peak == b == mx: the raw plane need not be kept);
//   3. write that plane's cidx over the raw plane, pool it along x, then y
//      over the core, and push into a second ring; midx of plane
//      zo = zi - 2 rz is that ring's max, and the voxel is a seed iff
//      midx == lin (only the voxel itself holds its index: cidx need not be
//      kept either). lin comes from coordinates and is never stored.
//
// Both poolings are skipped, with their barriers, for a step whose planes
// hold no value >= thr (b = -inf then: such a plane can neither hold nor
// beat a candidate) or no candidate. K1 (DIRS) takes the steepest-ascent
// step of a core quad where its seed status is known, reading the two maps
// at the quad and its neighbours through L1/L2 as 16-byte words
// (ascent_code for a quad at a ragged edge).
//
// The radius is a runtime value. rz sizes the register rings, so the kernel
// is compiled for rz = 0..kTileMaxR; ry and rx size the window, and the
// block has a thread for every quad of the largest one (a second, leaner
// build serves radii <= 2 on every axis: 416 threads, two blocks an SM).
// Larger radii take the chain below: up to seven whole-volume launches
// (maxpool_axis_kernel on x, y, z for the float map, candidate_index_kernel,
// the same three for the index map) through five volume-sized scratch
// buffers. The choice is the wrappers' (ops/peaks.nms_body), made from the
// radius before any launch.
//
// Bytes: the tile pass reads peak once over the window (1.56x the core at
// r = 2 on a 32 x 32 tile, the halo mostly from L2) and re-runs 4 rz planes
// per z chunk; K5 moves about 7 bytes a voxel where the chain moved ~8 in
// each of its launches. What bounds it now is the schedulers' slots at two blocks an
// SM (the rings hold it at 78 registers a thread): about 3x the time of its
// bytes at 96x512x512 (the same card).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace tpuseg {
namespace {

// ---------------------------------------------------------------- chain

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
                                       int* __restrict__ cidx,
                                       const float* __restrict__ thr, int D,
                                       int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const int i = (blockIdx.z * H + blockIdx.y) * W + x;
  const float v = peak[i];
  cidx[i] = (v >= *thr && v >= mx[i]) ? i : -1;
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

// Fills cidx and returns midx (in i0, i1 or, with every radius 0, cidx
// itself); nullptr with *err set when a launch fails. f0, f1 (float) and
// i0, i1 (int) are volume-sized scratch; *thr (device memory) is the peak
// threshold.
inline const int* nms_candidates(const float* peak, const float* thr,
                                 const int* radius, float* f0, float* f1,
                                 int* cidx, int* i0, int* i1, int D, int H,
                                 int W, cudaStream_t stream,
                                 cudaError_t* err) {
  const float* mx = maxpool3<float>(peak, f0, f1, radius, D, H, W, stream, err);
  if (*err != cudaSuccess) return nullptr;
  candidate_index_kernel<<<volume_grid(D, H, W), kThreads, 0, stream>>>(
      peak, mx, cidx, thr, D, H, W);
  *err = cudaGetLastError();
  if (*err != cudaSuccess) return nullptr;
  return maxpool3<int>(cidx, i0, i1, radius, D, H, W, stream, err);
}

// ------------------------------------------------------------ tile pass

constexpr int kTileMaxR = 4;           // the largest per-axis radius it takes
constexpr int kTileSmallR = 2;         // radii of the leaner build
constexpr int kTileY = 32, kTileX = 32;
constexpr int kTilePlanes = 4;         // planes a step
// blocks the grid should have before z is left whole: one for each of 132 SMs
constexpr int kTileBlocksWanted = 132;
constexpr int kTileMinChunk = 24;      // a z chunk re-runs 4 rz planes

// Dynamic shared memory of one block: per plane of a step the raw window
// twice (this step's, which becomes its cidx, and the next step's on its
// way) and the x-pooled plane of either.
inline int nms_tile_smem(int ry, int rx) {
  return 3 * kTilePlanes * (kTileY + 4 * ry) * (kTileX + 4 * rx) * 4;
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// One candidate of the steepest-ascent argmax over (potential, lin): the
// neighbour with code c, index j and potential np, left out where it lies
// outside the volume (`there` false). Visited in NEIGHBORS_6 order.
__device__ __forceinline__ void ascent_consider(bool there, float np, int j,
                                                int c, float& best_pot,
                                                int& best_idx, int& code) {
  if (there && (np > best_pot || (np == best_pot && j > best_idx))) {
    best_pot = np;
    best_idx = j;
    code = c;
  }
}

// The steepest-ascent direction code of foreground voxel i: argmax over
// {self} U 6 neighbours (NEIGHBORS_6 order) of (potential, lin), potential
// peak on the foreground and -inf off it, a neighbour outside the volume
// (has[c - 1] false) left out — watershed.steepest_dir_codes.
__device__ __forceinline__ int ascent_code(const float* __restrict__ peak,
                                           const float* __restrict__ fgp,
                                           float fg_thr, int i, int HW, int W,
                                           const bool (&has)[6]) {
  const int off[6] = {HW, -HW, W, -W, 1, -1};
  float best_pot = __ldg(peak + i);
  int best_idx = i, code = 0;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    if (!has[c]) continue;
    const int j = i + off[c];
    const float np =
        __ldg(fgp + j) >= fg_thr ? __ldg(peak + j) : -CUDART_INF_F;
    ascent_consider(true, np, j, c + 1, best_pot, best_idx, code);
  }
  return code;
}

// The potential of four neighbouring voxels from j on (16-byte aligned).
__device__ __forceinline__ void potential4(const float* __restrict__ peak,
                                           const float* __restrict__ fgp,
                                           float fg_thr, int j, float (&pot)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(fgp + j));
  const float4 p = __ldg(reinterpret_cast<const float4*>(peak + j));
  pot[0] = f.x >= fg_thr ? p.x : -CUDART_INF_F;
  pot[1] = f.y >= fg_thr ? p.y : -CUDART_INF_F;
  pot[2] = f.z >= fg_thr ? p.z : -CUDART_INF_F;
  pot[3] = f.w >= fg_thr ? p.w : -CUDART_INF_F;
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}
__device__ __forceinline__ int4 max4(int4 a, int4 b) {
  return make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z), max(a.w, b.w));
}
__device__ __forceinline__ float vfill(float) { return -CUDART_INF_F; }
__device__ __forceinline__ int vfill(int) { return -1; }

// Max over [x - rx, x + rx] for the four positions of the quad at `own`
// (16-byte aligned, in a row of a shared-memory plane); the quads to its
// left and right are read where the row has them, else count as fill.
template <int RMAX, typename T, typename T4>
__device__ __forceinline__ T4 pool_x_quad(const T* own, bool has_left,
                                          bool has_right, int rx) {
  const T fill = vfill(T());
  T a[12];
  const T4 c = *reinterpret_cast<const T4*>(own);
  T4 l, r;
  l.x = l.y = l.z = l.w = fill;
  r = l;
  if (has_left) l = *reinterpret_cast<const T4*>(own - 4);
  if (has_right) r = *reinterpret_cast<const T4*>(own + 4);
  a[0] = l.x, a[1] = l.y, a[2] = l.z, a[3] = l.w;
  a[4] = c.x, a[5] = c.y, a[6] = c.z, a[7] = c.w;
  a[8] = r.x, a[9] = r.y, a[10] = r.z, a[11] = r.w;
  T m[4] = {a[4], a[5], a[6], a[7]};
#pragma unroll
  for (int o = 1; o <= RMAX; ++o) {
    if (o > rx) break;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      m[e] = vmax(m[e], vmax(a[4 + e - o], a[4 + e + o]));
  }
  T4 out;
  out.x = m[0], out.y = m[1], out.z = m[2], out.w = m[3];
  return out;
}

// Max over rows [y - ry, y + ry] for the quad at `own` (row stride WX).
template <int RMAX, typename T, typename T4>
__device__ __forceinline__ T4 pool_y_quad(const T* own, int WX, int ry) {
  T4 m = *reinterpret_cast<const T4*>(own);
#pragma unroll
  for (int o = 1; o <= RMAX; ++o) {
    if (o > ry) break;
    m = max4(m, max4(*reinterpret_cast<const T4*>(own - o * WX),
                     *reinterpret_cast<const T4*>(own + o * WX)));
  }
  return m;
}

// RZ: the z radius. RMAX: the largest ry, rx (sizes the block: a thread
// owns one quad of four neighbouring x positions of the window).
// DIRS: K1 (dirs and v0 out) or K5 (the seed mask out). `vec`: W is a
// multiple of 4, rx is even and the volumes are 16-byte aligned, so a quad
// inside the volume is 16 bytes aligned in device memory too.
template <int RZ, int RMAX, int NT, bool DIRS>
__global__ void __launch_bounds__(NT, RMAX <= kTileSmallR ? 2 : 1)
nms_tile_kernel(const float* __restrict__ peak, const float* __restrict__ fgp,
                const float* __restrict__ thrs, int ry, int rx, int zchunk,
                int D, int H, int W, bool vec,
                unsigned char* __restrict__ seeds, int* __restrict__ dirs,
                int* __restrict__ v0) {
  constexpr int NR = 2 * RZ + 1;
  constexpr int P = kTilePlanes;
  static_assert((kTileY + 4 * RMAX) * (kTileX + 4 * RMAX) <= 4 * NT,
                "a quad for every thread");
  extern __shared__ __align__(16) unsigned char smem[];
  // the peak and foreground thresholds, from device memory (fg: K1 only)
  const float thr = __ldg(thrs);
  const float fg_thr = DIRS ? __ldg(thrs + 1) : 0.0f;
  const int hy = 2 * ry, hx = 2 * rx;
  const int WY = kTileY + 2 * hy, WX = kTileX + 2 * hx, WPOS = WY * WX;
  const int WQ = WX / 4;
  // raw planes [2][P] (a step's become its cidx planes), x-pooled planes [P]
  float* s_raw = reinterpret_cast<float*>(smem);
  float* s_a = s_raw + 2 * P * WPOS;
  int* s_ai = reinterpret_cast<int*>(s_a);

  const int tid = threadIdx.x;
  const int HW = H * W;
  const int za = blockIdx.z * zchunk;
  const int zb = min(za + zchunk, D);

  // this thread's quad: window positions w0 .. w0 + 3 of row wy; g0 is the
  // first one's offset in a plane of the volume, `inside` which of the four
  // lie in the volume, m_cand / m_core which belong to core + r / the core
  const bool valid = tid < WY * WQ;
  const int wy = tid / WQ, qx = tid - wy * WQ;
  const int w0 = 4 * tid;
  const int gy = blockIdx.y * kTileY - hy + wy;
  const int gx0 = blockIdx.x * kTileX - hx + 4 * qx;
  const int g0 = gy * W + gx0;
  const int ey = min(wy, WY - 1 - wy);
  const bool rows_r = valid && ey >= ry;    // rows of core + r
  const bool rows_core = valid && ey >= hy;
  const bool has_left = qx > 0, has_right = qx < WQ - 1;
  unsigned inside = 0, m_cand = 0, m_core = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int wx = 4 * qx + e;
    const int ex = min(wx, WX - 1 - wx);
    if (valid && gy >= 0 && gy < H && gx0 + e >= 0 && gx0 + e < W)
      inside |= 1u << e;
    if (rows_r && ex >= rx) m_cand |= 1u << e;
    if (rows_core && ex >= hx) m_core |= 1u << e;
  }
  const bool quad_out = vec && (m_core & inside) == 15u;  // 16-byte outputs

  float f[4][NR];   // 2-D pooled peak of planes zi - 2 RZ .. zi
  int g[4][NR];     // 2-D pooled cidx of planes zc - 2 RZ .. zc
  unsigned fl[4];   // bit j: peak == its 2-D pool in plane zi - j
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int j = 0; j < NR; ++j) f[e][j] = -CUDART_INF_F, g[e][j] = -1;
    fl[e] = 0;
  }

  // the raw windows of planes zo0 + 2 RZ .. + P - 1 on their way into `buf`
  auto fetch_ahead = [&](int zo0, int buf) {
    if (!valid) return;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int zi = zo0 + p + 2 * RZ;
      const bool plane = zi >= 0 && zi < D;
      float* dst = s_raw + (buf * P + p) * WPOS + w0;
      if (plane && vec && inside == 15u) {
        cp_async16(dst, peak + zi * HW + g0);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (plane && ((inside >> e) & 1u))
          cp_async4(dst + e, peak + zi * HW + g0 + e);
        else
          dst[e] = -CUDART_INF_F;
      }
    }
  };

  // outputs are planes zo in [za, zb). The first needs cidx from plane
  // za - RZ on, which needs pooled planes from za - 2 RZ on, pushed at
  // zo = za - 4 RZ. What the rings hold before that is shifted out.
  const int zstart = za - 4 * RZ;
  fetch_ahead(zstart, 0);
  for (int zo0 = zstart, buf = 0; zo0 < zb; zo0 += P, buf ^= 1) {
    float* s_p = s_raw + buf * P * WPOS;          // this step's raw planes
    int* s_c = reinterpret_cast<int*>(s_p);       // then their cidx

    // 1. this step's planes have arrived; start the next step's
    cp_async_wait_all();
    bool hi = false;
    if (valid) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(s_p + p * WPOS + w0);
        hi |= v.x >= thr || v.y >= thr || v.z >= thr || v.w >= thr;
      }
    }
    const bool any_hi = __syncthreads_or(hi);
    if (zo0 + P < zb) fetch_ahead(zo0 + P, buf ^ 1);

    // 2. pool along x, then along y into the ring; candidates of plane zc.
    // Positions less than rx from the window's edge pool over what is
    // there; nothing reads them.
    if (any_hi) {
      if (valid) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          *reinterpret_cast<float4*>(s_a + p * WPOS + w0) =
              pool_x_quad<RMAX, float, float4>(s_p + p * WPOS + w0, has_left,
                                               has_right, rx);
      }
      __syncthreads();
    }
    bool cand_any = false;
    if (valid) {
#pragma unroll 1
      for (int p = 0; p < P; ++p) {
        const int zc = zo0 + p + RZ;
        const bool zc_in = zc >= max(za - RZ, 0) && zc < D;
        float b[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                      -CUDART_INF_F};
        unsigned eq = 0;
        if (any_hi && rows_r) {
          const float4 m =
              pool_y_quad<RMAX, float, float4>(s_a + p * WPOS + w0, WX, ry);
          const float4 raw =
              *reinterpret_cast<const float4*>(s_p + p * WPOS + w0);
          b[0] = m.x, b[1] = m.y, b[2] = m.z, b[3] = m.w;
          eq = (raw.x == m.x ? 1u : 0u) | (raw.y == m.y ? 2u : 0u) |
               (raw.z == m.z ? 4u : 0u) | (raw.w == m.w ? 8u : 0u);
        }
        int c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool mine = (m_cand >> e) & 1u;
          if (!mine) b[e] = -CUDART_INF_F;
          float mx = b[e];
#pragma unroll
          for (int j = 0; j < NR - 1; ++j) {
            f[e][j] = f[e][j + 1];
            mx = fmaxf(mx, f[e][j]);
          }
          f[e][NR - 1] = b[e];
          fl[e] = (fl[e] << 1) | ((eq >> e) & 1u);
          const float fc = f[e][RZ];
          const bool cand = mine && zc_in && ((inside >> e) & 1u) &&
                            ((fl[e] >> RZ) & 1u) && fc >= thr && fc >= mx;
          c[e] = cand ? zc * HW + g0 + e : -1;
          cand_any |= cand;
        }
        // the quad's own positions of s_p: nobody else reads them any more
        if (rows_r)
          *reinterpret_cast<int4*>(s_c + p * WPOS + w0) =
              make_int4(c[0], c[1], c[2], c[3]);
      }
    }
    const bool any_c = __syncthreads_or(cand_any);

    // 3. pool cidx along x, then along y into the ring; seeds of plane zo
    if (any_c) {
      if (rows_r) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          *reinterpret_cast<int4*>(s_ai + p * WPOS + w0) =
              pool_x_quad<RMAX, int, int4>(s_c + p * WPOS + w0, has_left,
                                           has_right, rx);
      }
      __syncthreads();
    }
    if (!valid) continue;
#pragma unroll 1
    for (int p = 0; p < P; ++p) {
      const int zo = zo0 + p;
      int q[4] = {-1, -1, -1, -1};
      if (any_c && rows_core) {
        const int4 m = pool_y_quad<RMAX, int, int4>(s_ai + p * WPOS + w0, WX, ry);
        q[0] = m.x, q[1] = m.y, q[2] = m.z, q[3] = m.w;
      }
      const int i0 = zo * HW + g0;
      unsigned seed = 0;  // bit e: position e is an NMS seed
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!((m_core >> e) & 1u)) q[e] = -1;
        int midx = q[e];
#pragma unroll
        for (int j = 0; j < NR - 1; ++j) {
          g[e][j] = g[e][j + 1];
          midx = max(midx, g[e][j]);
        }
        g[e][NR - 1] = q[e];
        if (midx == i0 + e) seed |= 1u << e;
      }
      const unsigned out = m_core & inside;
      if (out == 0 || zo < za || zo >= zb) continue;
      if (!DIRS) {
        if (quad_out) {
          *reinterpret_cast<unsigned*>(seeds + i0) =
              (seed & 1u) | ((seed & 2u) << 7) | ((seed & 4u) << 14) |
              ((seed & 8u) << 21);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if ((out >> e) & 1u) seeds[i0 + e] = (seed >> e) & 1u;
        }
        continue;
      }
      // K1: the ascent step of every foreground voxel that is no seed
      const bool has_z[2] = {zo + 1 < D, zo > 0};
      const bool has_y[2] = {gy + 1 < H, gy > 0};
      if (quad_out) {
        float pc[4];
        const float4 fg4 = __ldg(reinterpret_cast<const float4*>(fgp + i0));
        const unsigned fg = (fg4.x >= fg_thr ? 1u : 0u) |
                            (fg4.y >= fg_thr ? 2u : 0u) |
                            (fg4.z >= fg_thr ? 4u : 0u) |
                            (fg4.w >= fg_thr ? 8u : 0u);
        seed &= fg;
        int code[4] = {0, 0, 0, 0};
        if (fg & ~seed) {
          const float4 p4 = __ldg(reinterpret_cast<const float4*>(peak + i0));
          pc[0] = fg & 1u ? p4.x : -CUDART_INF_F;
          pc[1] = fg & 2u ? p4.y : -CUDART_INF_F;
          pc[2] = fg & 4u ? p4.z : -CUDART_INF_F;
          pc[3] = fg & 8u ? p4.w : -CUDART_INF_F;
          float zp[4] = {}, zm[4] = {}, yp[4] = {}, ym[4] = {};
          if (has_z[0]) potential4(peak, fgp, fg_thr, i0 + HW, zp);
          if (has_z[1]) potential4(peak, fgp, fg_thr, i0 - HW, zm);
          if (has_y[0]) potential4(peak, fgp, fg_thr, i0 + W, yp);
          if (has_y[1]) potential4(peak, fgp, fg_thr, i0 - W, ym);
          const bool has_xp = gx0 + 4 < W, has_xm = gx0 > 0;
          float xp = -CUDART_INF_F, xm = -CUDART_INF_F;
          if (has_xp && __ldg(fgp + i0 + 4) >= fg_thr) xp = __ldg(peak + i0 + 4);
          if (has_xm && __ldg(fgp + i0 - 1) >= fg_thr) xm = __ldg(peak + i0 - 1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (!(((fg & ~seed) >> e) & 1u)) continue;
            const int i = i0 + e;
            float best_pot = pc[e];
            int best_idx = i;
            ascent_consider(has_z[0], zp[e], i + HW, 1, best_pot, best_idx,
                            code[e]);
            ascent_consider(has_z[1], zm[e], i - HW, 2, best_pot, best_idx,
                            code[e]);
            ascent_consider(has_y[0], yp[e], i + W, 3, best_pot, best_idx,
                            code[e]);
            ascent_consider(has_y[1], ym[e], i - W, 4, best_pot, best_idx,
                            code[e]);
            ascent_consider(e < 3 || has_xp, e < 3 ? pc[e < 3 ? e + 1 : 3] : xp,
                            i + 1, 5, best_pot, best_idx, code[e]);
            ascent_consider(e > 0 || has_xm, e > 0 ? pc[e > 0 ? e - 1 : 0] : xm,
                            i - 1, 6, best_pot, best_idx, code[e]);
          }
        }
        int root[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool is_fg = (fg >> e) & 1u;
          root[e] = (is_fg && code[e] == 0)
                        ? (((seed >> e) & 1u) ? i0 + e + 1 : -(i0 + e + 1))
                        : 0;
        }
        *reinterpret_cast<int4*>(dirs + i0) =
            make_int4(code[0], code[1], code[2], code[3]);
        *reinterpret_cast<int4*>(v0 + i0) =
            make_int4(root[0], root[1], root[2], root[3]);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!((out >> e) & 1u)) continue;
        const int i = i0 + e;
        const bool fg = __ldg(fgp + i) >= fg_thr;
        const bool is_seed = fg && ((seed >> e) & 1u);
        int code = 0;
        if (fg && !is_seed) {
          const bool has[6] = {has_z[0], has_z[1], has_y[0], has_y[1],
                               gx0 + e + 1 < W, gx0 + e > 0};
          code = ascent_code(peak, fgp, fg_thr, i, HW, W, has);
        }
        dirs[i] = code;
        v0[i] = (fg && code == 0) ? (is_seed ? i + 1 : -(i + 1)) : 0;
      }
    }
  }
}

template <int RZ, int RMAX, int NT, bool DIRS>
cudaError_t launch_nms_tile_rz(const float* peak, const float* fgp,
                               const float* thrs, int ry, int rx, int D,
                               int H, int W, unsigned char* seeds,
                               int* dirs, int* v0, cudaStream_t stream) {
  auto kernel = nms_tile_kernel<RZ, RMAX, NT, DIRS>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        nms_tile_smem(RMAX, RMAX));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int ty = (H + kTileY - 1) / kTileY, tx = (W + kTileX - 1) / kTileX;
  const int nz = max(min((kTileBlocksWanted + ty * tx - 1) / (ty * tx),
                         D / kTileMinChunk),
                     1);
  const int zchunk = (D + nz - 1) / nz;
  const dim3 grid(tx, ty, (D + zchunk - 1) / zchunk);
  const auto addr = [](const void* ptr) {
    return reinterpret_cast<std::uintptr_t>(ptr);
  };
  const bool vec =
      W % 4 == 0 && rx % 2 == 0 &&
      (addr(peak) | addr(fgp) | addr(seeds) | addr(dirs) | addr(v0)) % 16 == 0;
  kernel<<<grid, NT, nms_tile_smem(ry, rx), stream>>>(
      peak, fgp, thrs, ry, rx, zchunk, D, H, W, vec, seeds, dirs, v0);
  return cudaGetLastError();
}

// The tile pass over the whole volume: the seed mask (DIRS false; fgp,
// dirs, v0 unused) or dirs and v0 (DIRS true; seeds unused). thrs: device
// memory holding the peak threshold and (DIRS) the foreground threshold.
// Radii above kTileMaxR are refused: the wrappers send those to the chain.
template <bool DIRS>
cudaError_t launch_nms_tile(const float* peak, const float* fgp,
                            const float* thrs, int rz, int ry, int rx, int D,
                            int H, int W, unsigned char* seeds, int* dirs,
                            int* v0, cudaStream_t s) {
  if (min(rz, min(ry, rx)) < 0 || max(rz, max(ry, rx)) > kTileMaxR)
    return cudaErrorInvalidValue;
#define TPUSEG_TILE(RZ, RMAX, NT)                                            \
  return launch_nms_tile_rz<RZ, RMAX, NT, DIRS>(peak, fgp, thrs, ry, rx, D, \
                                                H, W, seeds, dirs, v0, s)
  if (max(rz, max(ry, rx)) <= kTileSmallR) {
    // window at most 40 x 40: 400 quads
    switch (rz) {
      case 0: TPUSEG_TILE(0, kTileSmallR, 416);
      case 1: TPUSEG_TILE(1, kTileSmallR, 416);
      default: TPUSEG_TILE(2, kTileSmallR, 416);
    }
  }
  // window at most 48 x 48: 576 quads
  switch (rz) {
    case 0: TPUSEG_TILE(0, kTileMaxR, 576);
    case 1: TPUSEG_TILE(1, kTileMaxR, 576);
    case 2: TPUSEG_TILE(2, kTileMaxR, 576);
    case 3: TPUSEG_TILE(3, kTileMaxR, 576);
    default: TPUSEG_TILE(4, kTileMaxR, 576);
  }
#undef TPUSEG_TILE
}

}  // namespace
}  // namespace tpuseg
