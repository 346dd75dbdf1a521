// MedNeXt's depthwise 5^3 convolutions (D1; no Pallas counterpart: the net
// is the port's alone).
//
// For a bf16 NCDHW tensor x whose (n, c) planes lie contiguous, the
// module's float32 depthwise kernel w (C, 1, 5, 5, 5) and bias b (C), each
// plane convolved with its channel's kernel, pad 2:
//
//   form 0: out[o] = b + sum_k x[o - 2 + k] w[k]        (stride 1)
//   form 1: out[o] = b + sum_k x[2 o - 2 + k] w[k]      (stride 2)
//   form 2: out[2 i - 2 + k] += x[i] w[k], plus b       (stride 2 transposed,
//                                                         sides 2S - 1)
//
// x outside the volume reads 0. The operands are bf16 (the weight and the
// bias rounded to it), every product and the sum float32 with the bias
// first, the output rounded to bf16 once.
//
// What bounds it: operations on the CUDA cores. A 5^3 tap is 125 FMAs an
// output against 4 bytes moved (2 read, 2 written), 62 FLOP a byte, about
// 3x past the ridge of the card's float32 rate (67 TFLOP/s) against its
// memory rate (3.35 TB/s). A tensor-core form would have K = 125 taps of
// one channel and N = 1, and be bound by bytes instead.
//
// Forms 0 and 1, dwconv_kernel: one CTA for an output tile (TZ, TY, TX) of
// one plane (blockIdx.y = plane). The CTA stages its input box (TZ-1)S+5 x
// (TY-1)S+5 x (TX-1)S+5, zero outside the volume, in shared memory as
// float32, rows padded to 16 bytes (16-byte loads of aligned 8-element
// runs); the plane's 125 taps are rounded once a CTA into shared memory and
// every thread holds them in registers. A thread computes ZR planes x V = 4 columns of outputs at
// one row: for each input plane and tap row it reads one row of the box in
// 16-byte vectors and feeds every output plane that tap plane reaches, so
// at stride 1 a row read serves up to 4 x 5 x 4 = 80 FMAs. Stride 1 takes
// TX 32, 16 or 8 by the width (TY 16, 16, 8; TZ 8; ZR 4); stride 2 one
// tile (4, 8, 16) with ZR 1.
// Form 2, dwconv_t_kernel: outputs 2m + p (p = 0, 1 an axis) take taps k
// with p - k even from inputs m + (p + 2 - k) / 2, so each input position m
// of a tile (4, 4, 16) of the input grid owns its 8 outputs: a thread reads
// the 27 inputs around m from the staged box once and does the 125 FMAs of
// its 8 outputs (3 or 2 taps an axis).
//
// No atomics: the same input gives the same bits on every call. Launch
// errors come back as the entry point's return value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpuseg {
namespace {

constexpr int K = 5;
constexpr int KPAD = 2;
constexpr int TAPS = K * K * K;
constexpr int V = 4;                   // output columns a thread

// a float32 parameter as the bf16 operand it is rounded to
__device__ __forceinline__ float operand(const float* p) {
  return __bfloat162float(__float2bfloat16_rn(__ldg(p)));
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// The input box of an output tile, staged as float32 with zeros outside the
// volume: column j of a box row holds global x0 + j (pitch PX floats, a
// multiple of 4). A work item is one run of 8 elements of a box row, the
// runs aligned in global memory (the first starts at x0 rounded down to a
// multiple of 8): one 16-byte load where the run lies inside a row whose
// width is a multiple of 8 (and the plane 16-byte aligned), else element by
// element; its elements that fall in [0, PX) go to the box.
template <int BZ, int BY, int PX, int NT>
__device__ __forceinline__ void stage(float (&box)[BZ][BY][PX],
                                      const __nv_bfloat16* __restrict__ xp,
                                      int z0, int y0, int x0, int D, int H,
                                      int W) {
  constexpr int RUNS = (PX + 14) / 8;             // cover [x0, x0 + PX)
  const long long HW = static_cast<long long>(H) * W;
  const int xa = x0 >= 0 ? x0 / 8 * 8 : -((7 - x0) / 8) * 8;
  const int off = x0 - xa;                        // 0..7
  const bool vec = W % 8 == 0 && reinterpret_cast<uintptr_t>(xp) % 16 == 0;
  for (int e = threadIdx.x; e < BZ * BY * RUNS; e += NT) {
    const int k = e % RUNS, r = e / RUNS, yy = r % BY, zz = r / BY;
    const int gz = z0 + zz, gy = y0 + yy, gx = xa + 8 * k;
    const bool row = gz >= 0 && gz < D && gy >= 0 && gy < H;
    float v[8];
    if (row && vec && gx >= 0 && gx + 8 <= W) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          xp + gz * HW + static_cast<long long>(gy) * W + gx));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(h[q]);
        v[2 * q] = f.x;
        v[2 * q + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[q] = row && gx + q >= 0 && gx + q < W
                   ? __bfloat162float(xp[gz * HW + static_cast<long long>(gy) *
                                                      W + gx + q])
                   : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = 8 * k + q - off;
      if (j >= 0 && j < PX) box[zz][yy][j] = v[q];
    }
  }
}

// The plane's 125 taps and its bias as bf16 operands in float32, staged in
// shared memory once a CTA (taps[TAPS] is the bias).
template <int NT>
__device__ __forceinline__ void stage_taps(float* taps, const float* w,
                                           const float* b, int c) {
  for (int i = threadIdx.x; i <= TAPS; i += NT)
    taps[i] = operand(i < TAPS ? w + c * TAPS + i : b + c);
}

template <int S, int TZ, int TY, int TX, int ZR>
__global__ void __launch_bounds__((TX / V) * TY * (TZ / ZR))
dwconv_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ b, __nv_bfloat16* __restrict__ out,
              int C, int D, int H, int W, int OD, int OH, int OW, int tiles_y,
              int tiles_x) {
  constexpr int NT = (TX / V) * TY * (TZ / ZR);
  constexpr int RL = round4((V - 1) * S + K);        // a thread's row
  constexpr int BZ = (TZ - 1) * S + K, BY = (TY - 1) * S + K;
  constexpr int PX = round4((TX - V) * S + RL);
  constexpr int ZIN = (ZR - 1) * S + K;              // a thread's planes
  __shared__ __align__(16) float box[BZ][BY][PX];

  const long long plane = blockIdx.y;
  const int c = static_cast<int>(plane % C);
  int t = blockIdx.x;
  const int X0 = (t % tiles_x) * TX;
  t /= tiles_x;
  const int Y0 = (t % tiles_y) * TY, Z0 = (t / tiles_y) * TZ;
  __shared__ __align__(16) float taps[TAPS + 3];
  stage<BZ, BY, PX, NT>(box, x + plane * D * static_cast<long long>(H) * W,
                        S * Z0 - KPAD, S * Y0 - KPAD, S * X0 - KPAD, D, H, W);
  stage_taps<NT>(taps, w, b, c);
  __syncthreads();
  float wr[TAPS];
#pragma unroll
  for (int i = 0; i < TAPS; ++i) wr[i] = taps[i];
  const float bias = taps[TAPS];

  const int vx = threadIdx.x % (TX / V);
  const int ty = (threadIdx.x / (TX / V)) % TY;
  const int tz = threadIdx.x / ((TX / V) * TY);
  float acc[ZR][V];
#pragma unroll
  for (int zo = 0; zo < ZR; ++zo)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[zo][v] = bias;
#pragma unroll
  for (int iz = 0; iz < ZIN; ++iz) {
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const float4* row = reinterpret_cast<const float4*>(
          &box[tz * ZR * S + iz][ty * S + dy][vx * V * S]);
      float r[RL];
#pragma unroll
      for (int q = 0; q < RL / 4; ++q) {
        const float4 f = row[q];
        r[4 * q] = f.x;
        r[4 * q + 1] = f.y;
        r[4 * q + 2] = f.z;
        r[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int zo = 0; zo < ZR; ++zo) {
        const int dz = iz - S * zo;
        if (dz < 0 || dz >= K) continue;
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const float wv = wr[(dz * K + dy) * K + dx];
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[zo][v] = __fmaf_rn(r[S * v + dx], wv, acc[zo][v]);
        }
      }
    }
  }

  const int gy = Y0 + ty, gx = X0 + vx * V;
  if (gy >= OH || gx >= OW) return;
  const long long OHW = static_cast<long long>(OH) * OW;
  __nv_bfloat16* op = out + plane * OD * OHW + static_cast<long long>(gy) * OW;
#pragma unroll
  for (int zo = 0; zo < ZR; ++zo) {
    const int gz = Z0 + tz * ZR + zo;
    if (gz >= OD) break;
    __nv_bfloat16* o = op + gz * OHW + gx;
    if (OW % V == 0) {                  // gx + 3 < OW and 8-byte aligned
      __nv_bfloat162 lo = __floats2bfloat162_rn(acc[zo][0], acc[zo][1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(acc[zo][2], acc[zo][3]);
      uint2 pk;
      pk.x = *reinterpret_cast<uint32_t*>(&lo);
      pk.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(o) = pk;
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (gx + v < OW) o[v] = __float2bfloat16_rn(acc[zo][v]);
    }
  }
}

// the stride-2 transposed form over a tile (MZ, MY, MX) of the input grid
constexpr int MZ = 4, MY = 4, MX = 16;

__global__ void __launch_bounds__(MZ * MY * MX)
dwconv_t_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ w, const float* __restrict__ b,
                __nv_bfloat16* __restrict__ out,
                int C, int D, int H, int W, int tiles_y, int tiles_x) {
  constexpr int NT = MZ * MY * MX;
  constexpr int BZ = MZ + 2, BY = MY + 2, PX = round4(MX + 2);
  __shared__ __align__(16) float box[BZ][BY][PX];

  const long long plane = blockIdx.y;
  const int c = static_cast<int>(plane % C);
  int t = blockIdx.x;
  const int X0 = (t % tiles_x) * MX;
  t /= tiles_x;
  const int Y0 = (t % tiles_y) * MY, Z0 = (t / tiles_y) * MZ;
  __shared__ __align__(16) float taps[TAPS + 3];
  stage<BZ, BY, PX, NT>(box, x + plane * D * static_cast<long long>(H) * W,
                        Z0 - 1, Y0 - 1, X0 - 1, D, H, W);
  stage_taps<NT>(taps, w, b, c);
  __syncthreads();
  float wr[TAPS];
#pragma unroll
  for (int i = 0; i < TAPS; ++i) wr[i] = taps[i];
  const float bias = taps[TAPS];

  const int lx = threadIdx.x % MX, ly = (threadIdx.x / MX) % MY,
            lz = threadIdx.x / (MX * MY);
  const int mz = Z0 + lz, my = Y0 + ly, mx = X0 + lx;
  if (mz >= D || my >= H || mx >= W) return;
  // in[a][b][c]: the input at m - 1 + (a, b, c)
  float in[3][3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int bb = 0; bb < 3; ++bb)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) in[a][bb][cc] = box[lz + a][ly + bb][lx + cc];

  const int OD = 2 * D - 1, OH = 2 * H - 1, OW = 2 * W - 1;
  const long long OHW = static_cast<long long>(OH) * OW;
  __nv_bfloat16* op = out + plane * OD * OHW;
#pragma unroll
  for (int pz = 0; pz < 2; ++pz)
#pragma unroll
    for (int py = 0; py < 2; ++py)
#pragma unroll
      for (int px = 0; px < 2; ++px) {
        const int oz = 2 * mz + pz, oy = 2 * my + py, ox = 2 * mx + px;
        float acc = bias;
        // tap k reaches output 2m + p from input m + (p + 2 - k) / 2
#pragma unroll
        for (int kz = pz; kz < K; kz += 2)
#pragma unroll
          for (int ky = py; ky < K; ky += 2)
#pragma unroll
            for (int kx = px; kx < K; kx += 2)
              acc = __fmaf_rn(in[1 + (pz + 2 - kz) / 2][1 + (py + 2 - ky) / 2]
                                [1 + (px + 2 - kx) / 2],
                              wr[(kz * K + ky) * K + kx], acc);
        if (oz < OD && oy < OH && ox < OW)
          op[oz * OHW + static_cast<long long>(oy) * OW + ox] =
              __float2bfloat16_rn(acc);
      }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int S, int TZ, int TY, int TX, int ZR>
int launch(const void* x, const float* w, const float* b, void* out,
           int planes, int C, int D, int H, int W, cudaStream_t st) {
  const int OD = (D - 1) / S + 1, OH = (H - 1) / S + 1, OW = (W - 1) / S + 1;
  const int ty = cdiv(OH, TY), tx = cdiv(OW, TX);
  const dim3 grid(static_cast<unsigned>(cdiv(OD, TZ) * ty * tx),
                  static_cast<unsigned>(planes));
  dwconv_kernel<S, TZ, TY, TX, ZR><<<grid, (TX / V) * TY * (TZ / ZR), 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), w, b,
      static_cast<__nv_bfloat16*>(out), C, D, H, W, OD, OH, OW, ty, tx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tpuseg

// out <- the depthwise conv of form `form` (0: stride 1; 1: stride 2; 2:
// stride 2 transposed) of x (planes = N * C planes of D x H x W, bf16), w
// (C, 125) and b (C), float32.
extern "C" int tpuseg_dwconv(const void* x, const void* w, const void* b,
                             void* out, int planes, int channels, int D,
                             int H, int W, int form, void* stream) {
  using namespace tpuseg;
  if (planes < 1 || planes > 65535 || channels < 1 || planes % channels ||
      D < 1 || H < 1 || W < 1 || form < 0 || form > 2 || !w || !b)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (form == 0) {
    if (W > 16)
      return launch<1, 8, 16, 32, 4>(x, wf, bf, out, planes, channels, D, H,
                                     W, st);
    if (W > 8)
      return launch<1, 8, 16, 16, 4>(x, wf, bf, out, planes, channels, D, H,
                                     W, st);
    return launch<1, 8, 8, 8, 4>(x, wf, bf, out, planes, channels, D, H, W,
                                 st);
  }
  if (form == 1)
    return launch<2, 4, 8, 16, 1>(x, wf, bf, out, planes, channels, D, H, W,
                                  st);
  const int ty = cdiv(H, MY), tx = cdiv(W, MX);
  const dim3 grid(static_cast<unsigned>(cdiv(D, MZ) * ty * tx),
                  static_cast<unsigned>(planes));
  dwconv_t_kernel<<<grid, MZ * MY * MX, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), wf, bf,
      static_cast<__nv_bfloat16*>(out), channels, D, H, W, ty, tx);
  return static_cast<int>(cudaGetLastError());
}
