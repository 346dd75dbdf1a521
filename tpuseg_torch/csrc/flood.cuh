// K3's kernel: several lockstep flood steps per trip through device memory.
//
// A flood step is a wavefront (an unlabelled foreground voxel takes the label
// of its labelled 6-neighbour with the largest (potential, linear index);
// labelled voxels never change), so steps cannot be composed like the chase's
// hops: they are blocked in time. A block owns a (TY, TX) tile of (y, x)
// with a halo of HMAX and marches over z with a ring of HMAX + 2 planes in
// shared memory. At march step s it fetches plane s + 1 into registers, runs
// level t = 1..h on plane s - t (which needs planes s - t - 1 .. s - t + 1
// at level t - 1), writes plane s - h back (core only), and stores the
// fetched plane into the slot of plane s - h - 1, dead by then.
//
// Time levels share one copy of a plane: beside label and potential each
// position carries a state byte, the level at which it became a giver
// (0 = labelled on input), or kOpen (unlabelled foreground: may take), kInert
// (in the volume, neither takes nor gives: off the foreground, or a label
// below 0) or kOut (window position outside the volume, decided by its
// coordinates). Level t takes only from states < t, so a label written at
// level t is invisible to level t however the planes' levels interleave:
// lockstep in place and no buffer per level. A level whose plane holds no
// open position is skipped with its barrier, so a tile with nothing to flood
// just copies.
//
// What bounds it is the schedulers' slots, not device memory: staging a
// voxel through shared memory one at a time cost over a hundred operations a
// launch. So a thread owns four neighbouring x positions (a quad): planes
// move as 16-byte words where W allows it, the four state bytes are one word,
// and a level finds its front (open positions with a giver beside them) with
// byte-wise SIMD compares on the state words of the quad and its six
// neighbours; a quad with no open position costs one load and one compare
// per level. Only a front voxel makes a scalar choice, among the givers
// that the compares found.
//
// A position less than t from the window's edge cannot be right at level t
// (it misses neighbours outside) and is not needed: level t runs only on
// positions t or more inside, which read neighbours that are right through
// level t - 1. With several z chunks the same holds along z, where the
// planes near a chunk's fetched range are computed and never written back.
//
// The tie-break needs no index arithmetic: among the six neighbours linear
// indices always order z+1 > y+1 > x+1 > x-1 > y-1 > z-1, so candidates are
// visited in that order and replaced only by a strictly larger key. As in
// the plain version, an in-volume neighbour that is no giver competes with
// key -inf (it can shadow a giver whose potential is -inf), and a NaN key
// never wins.
//
// Device memory: at HMAX = 4 and a 32 x 32 tile a launch reads 8 bytes per
// window position (1.6x the core, the halo mostly from L2) and writes 4 per
// voxel, about a fifth of the bytes of four whole-volume steps.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace tpuseg {
namespace {

constexpr unsigned kOpen = 253, kInert = 254, kOut = 255;
constexpr int kFloodBlocksWanted = 198;  // 1.5 blocks for each of 132 SMs

template <int HMAX, int TY, int TX, int NT>
struct FloodTile {
  static_assert(TX % 4 == 0, "a tile row is whole quads");
  static constexpr int HX = (HMAX + 3) / 4 * 4;     // x halo: whole quads
  static constexpr int WY = TY + 2 * HMAX;
  static constexpr int WX = TX + 2 * HX;
  static constexpr int WPOS = WY * WX;
  static constexpr int WQ = WX / 4;                 // quads per window row
  static constexpr int NQ = WY * WQ;                // quads per plane
  static constexpr int CQ = TX / 4;                 // core quads per row
  static constexpr int NSLOT = HMAX + 2;
  static constexpr int QPT = (NQ + NT - 1) / NT;    // quads per thread
  static constexpr int CPT = (TY * CQ + NT - 1) / NT;
  // label (int) + potential (float) + state (byte) per position and slot
  static constexpr int kSmemBytes = NSLOT * WPOS * 9;
};

// 0xff in every byte of `states` that is a giver before level t.
__device__ __forceinline__ unsigned givers4(unsigned states, unsigned t) {
  return __vcmpltu4(states, t * 0x01010101u);
}

// The whole rule for the open voxel at position q (planes at `base`, `up`,
// `dn` of the ring) at level t: returns the position of the giver to take
// from, or -1. All four in-plane neighbours are inside the window. The
// kernel needs it only where a giver's key is -inf.
template <int WX>
__device__ __forceinline__ int flood_choice(const unsigned char* s_st,
                                            const float* s_pot, int q,
                                            int base, int up, int dn,
                                            bool has_up, bool has_dn,
                                            unsigned t) {
  float best = -CUDART_INF_F;
  bool accepted = false;
  int winner = -1;
  auto candidate = [&](bool there, int i) {
    if (!there) return;
    const unsigned st = s_st[i];
    if (st == kOut) return;
    const bool giver = st < t;
    const float key = giver ? s_pot[i] : -CUDART_INF_F;
    if (key > best || (!accepted && key == best)) {
      best = key;
      accepted = true;
      winner = giver ? i : -1;
    }
  };
  candidate(has_up, q - base + up);
  candidate(true, q + WX);
  candidate(true, q + 1);
  candidate(true, q - 1);
  candidate(true, q - WX);
  candidate(has_dn, q - base + dn);
  return winner;
}

// h (1..HMAX) lockstep flood steps from `in` into `out` (no alias) for the
// tile (blockIdx.y, blockIdx.x) and the z chunk blockIdx.z of `zchunk`
// planes. Sets *changed to 1 if a core voxel took a label. `vec`: W is a
// multiple of 4 and the three volumes are 16-byte aligned. With `gate` set
// the launch runs only if *gate != 0 (else every block returns at once,
// `out` untouched).
template <int HMAX, int TY, int TX, int NT>
__global__ void __launch_bounds__(NT)
flood_march_kernel(const float* __restrict__ pot, const int* __restrict__ in,
                   int* __restrict__ out, int* __restrict__ changed, int h,
                   int zchunk, int D, int H, int W, bool vec,
                   const int* __restrict__ gate) {
  if (gate != nullptr && *gate == 0) return;  // uniform over the grid
  using T = FloodTile<HMAX, TY, TX, NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_lab = reinterpret_cast<int*>(smem);
  float* s_pot = reinterpret_cast<float*>(smem + T::NSLOT * T::WPOS * 4);
  unsigned char* s_st = smem + T::NSLOT * T::WPOS * 8;
  unsigned* s_st4 = reinterpret_cast<unsigned*>(s_st);

  const int tid = threadIdx.x;
  const int HW = H * W;
  const int za = blockIdx.z * zchunk;
  const int zb = min(za + zchunk, D);
  const int lo = max(za - h, 0);   // planes [lo, hi) pass through the ring
  const int hi = min(zb + h, D);

  // this thread's quads: offset of the first position in a plane, which of
  // the four lie in the volume, the quad's place in its window row and the
  // row's distance to the window's edge (0 for a thread with no quad)
  int goff[T::QPT], wq[T::QPT], ymargin[T::QPT];
  unsigned inside[T::QPT];
#pragma unroll
  for (int k = 0; k < T::QPT; ++k) {
    const int qi = tid + k * NT;
    const int wy = qi / T::WQ;
    wq[k] = qi - wy * T::WQ;
    const int gy = blockIdx.y * TY - HMAX + wy;
    const int gx = blockIdx.x * TX - T::HX + 4 * wq[k];
    const bool row = qi < T::NQ && gy >= 0 && gy < H;
    goff[k] = gy * W + gx;
    inside[k] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (row && gx + e >= 0 && gx + e < W) inside[k] |= 1u << e;
    ymargin[k] = qi < T::NQ ? min(wy, T::WY - 1 - wy) : 0;
  }

  int rl[T::QPT][4];
  float rp[T::QPT][4];
  unsigned open_mask = 0;  // bit per slot: the plane holds an open position

  auto fetch = [&](int z) {
#pragma unroll
    for (int k = 0; k < T::QPT; ++k) {
      if (vec && inside[k] == 15u) {
        const int4 a =
            __ldg(reinterpret_cast<const int4*>(in + z * HW + goff[k]));
        const float4 b =
            __ldg(reinterpret_cast<const float4*>(pot + z * HW + goff[k]));
        rl[k][0] = a.x, rl[k][1] = a.y, rl[k][2] = a.z, rl[k][3] = a.w;
        rp[k][0] = b.x, rp[k][1] = b.y, rp[k][2] = b.z, rp[k][3] = b.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = (inside[k] >> e) & 1u;
          rl[k][e] = ok ? __ldg(in + z * HW + goff[k] + e) : 0;
          rp[k][e] = ok ? __ldg(pot + z * HW + goff[k] + e) : -CUDART_INF_F;
        }
      }
    }
  };
  // ends in a barrier; every thread gets the same open_mask
  auto store = [&](int z) {
    const int slot = (z - lo) % T::NSLOT;
    bool any_open = false;
#pragma unroll
    for (int k = 0; k < T::QPT; ++k) {
      const int qi = tid + k * NT;
      if (qi >= T::NQ) break;
      unsigned states = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        unsigned st = kOut;
        if ((inside[k] >> e) & 1u) {
          if (rl[k][e] != 0) st = rl[k][e] > 0 ? 0u : kInert;
          else st = rp[k][e] > -CUDART_INF_F ? kOpen : kInert;
        }
        any_open |= st == kOpen;
        states |= st << (8 * e);
      }
      const int at = slot * T::WPOS + 4 * qi;
      *reinterpret_cast<int4*>(s_lab + at) =
          make_int4(rl[k][0], rl[k][1], rl[k][2], rl[k][3]);
      *reinterpret_cast<float4*>(s_pot + at) =
          make_float4(rp[k][0], rp[k][1], rp[k][2], rp[k][3]);
      s_st4[at / 4] = states;
    }
    const unsigned bit = 1u << slot;
    open_mask = __syncthreads_or(any_open) ? (open_mask | bit)
                                           : (open_mask & ~bit);
  };

  fetch(lo);
  store(lo);
  bool took = false;
  for (int s = lo; s < hi + h; ++s) {
    const bool more = s + 1 < hi;
    if (more) fetch(s + 1);
    for (int t = 1; t <= h; ++t) {
      const int z = s - t;
      if (z < lo || z >= hi) continue;
      const int slot = (z - lo) % T::NSLOT;
      if (!((open_mask >> slot) & 1u)) continue;
      const int base = slot * T::WPOS;
      const bool has_up = z + 1 < hi, has_dn = z - 1 >= lo;
      const int up = ((z + 1 - lo) % T::NSLOT) * T::WPOS;
      const int dn = ((z - 1 - lo + T::NSLOT) % T::NSLOT) * T::WPOS;
#pragma unroll
      for (int k = 0; k < T::QPT; ++k) {
        // level t is owed only t or more positions inside the window's edge
        // (see the header), so a row that takes part has both its neighbours
        if (ymargin[k] < t) continue;
        const int qi = tid + k * NT;
        const int wi = base / 4 + qi;
        const unsigned own = s_st4[wi];
        const unsigned opens = __vcmpeq4(own, kOpen * 0x01010101u);
        if (opens == 0) continue;
        // the same along x, position by position
        const int xlo = 4 * wq[k], xhi = T::WX - 4 - xlo;
        unsigned owed = 0xffffffffu;
        if (xlo < t || xhi < t) {
          owed = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (xlo + e >= t && xhi + 3 - e >= t) owed |= 0xffu << (8 * e);
        }
        // state words of the six neighbouring quads; a plane that was not
        // fetched gives none, and a quad at the row's end reads itself for
        // the word beyond it (only positions that are not owed see that)
        const unsigned left = s_st4[wi - (wq[k] > 0 ? 1 : 0)];
        const unsigned right = s_st4[wi + (wq[k] < T::WQ - 1 ? 1 : 0)];
        const unsigned ut = static_cast<unsigned>(t);
        const unsigned g_up = has_up ? givers4(s_st4[up / 4 + qi], ut) : 0u;
        const unsigned g_yp = givers4(s_st4[wi + T::WQ], ut);
        const unsigned g_xp = givers4((own >> 8) | (right << 24), ut);
        const unsigned g_xm = givers4((own << 8) | (left >> 24), ut);
        const unsigned g_ym = givers4(s_st4[wi - T::WQ], ut);
        const unsigned g_dn = has_dn ? givers4(s_st4[dn / 4 + qi], ut) : 0u;
        unsigned front =
            opens & owed & (g_up | g_yp | g_xp | g_xm | g_ym | g_dn);
        while (front != 0) {
          const int sh = (__ffs(front) - 1) & ~7;
          front &= ~(0xffu << sh);
          const int q = base + 4 * qi + (sh >> 3);
          // the best giver, in descending linear index; a neighbour that is
          // no giver has key -inf and cannot beat a giver on the foreground
          float best = -CUDART_INF_F;
          int winner = -1;
          auto giver = [&](unsigned mask, int i) {
            if (((mask >> sh) & 1u) == 0) return;
            const float key = s_pot[i];
            if (key > best || (winner < 0 && key == best)) {
              best = key;
              winner = i;
            }
          };
          giver(g_up, q - base + up);
          giver(g_yp, q + T::WX);
          giver(g_xp, q + 1);
          giver(g_xm, q - 1);
          giver(g_ym, q - T::WX);
          giver(g_dn, q - base + dn);
          // a giver off the foreground (key -inf): the whole rule decides
          if (winner >= 0 && !(best > -CUDART_INF_F))
            winner = flood_choice<T::WX>(s_st, s_pot, q, base, up, dn, has_up,
                                         has_dn, ut);
          if (winner >= 0) {
            s_lab[q] = s_lab[winner];
            s_st[q] = static_cast<unsigned char>(t);
          }
        }
      }
      __syncthreads();  // uniform: z, slot and open_mask are block-wide
    }
    const int zo = s - h;
    if (zo >= za && zo < zb) {
      const int base = ((zo - lo) % T::NSLOT) * T::WPOS;
#pragma unroll
      for (int k = 0; k < T::CPT; ++k) {
        const int c = tid + k * NT;
        const int cy = c / T::CQ;
        const int cx = 4 * (c - cy * T::CQ);
        const int gy = blockIdx.y * TY + cy;
        const int gx = blockIdx.x * TX + cx;
        if (c >= TY * T::CQ || gy >= H || gx >= W) continue;
        const int at = base + (cy + HMAX) * T::WX + T::HX + cx;
        const int4 v = *reinterpret_cast<const int4*>(s_lab + at);
        int* dst = out + zo * HW + gy * W + gx;
        if (vec && gx + 3 < W) {
          *reinterpret_cast<int4*>(dst) = v;
        } else {
          const int lab[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (gx + e < W) dst[e] = lab[e];
        }
        // states 1..HMAX: took in this launch (kOut never matches)
        const unsigned states = s_st4[at / 4];
        took |= (givers4(states, HMAX + 1) & ~__vcmpeq4(states, 0u)) != 0;
      }
    }
    if (more) store(s + 1);
  }
  if (__syncthreads_or(took) && tid == 0) *changed = 1;
}

// One launch of flood_march_kernel over the whole volume: h <= HMAX steps,
// gated on *gate where `gate` is set.
template <int HMAX, int TY, int TX, int NT>
cudaError_t launch_flood(const float* pot, const int* in, int* out,
                         int* changed, int h, int D, int H, int W,
                         cudaStream_t stream, const int* gate = nullptr) {
  using T = FloodTile<HMAX, TY, TX, NT>;
  auto kernel = flood_march_kernel<HMAX, TY, TX, NT>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  // z chunks only where (y, x) tiles alone leave most SMs idle; a chunk
  // recomputes h planes on either side, so it stays at 32 planes or more
  const int ty = (H + TY - 1) / TY, tx = (W + TX - 1) / TX;
  int nz = min((kFloodBlocksWanted + ty * tx - 1) / (ty * tx), (D + 31) / 32);
  nz = max(nz, 1);
  const int zchunk = (D + nz - 1) / nz;
  const dim3 grid(tx, ty, (D + zchunk - 1) / zchunk);
  const auto addr = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p);
  };
  const bool vec = W % 4 == 0 && (addr(pot) | addr(in) | addr(out)) % 16 == 0;
  kernel<<<grid, NT, T::kSmemBytes, stream>>>(pot, in, out, changed, h,
                                              zchunk, D, H, W, vec, gate);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpuseg
