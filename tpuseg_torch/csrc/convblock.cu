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
// Design: a CTA owns an 8-row x 30-column (y, x) tile and marches over a
// chunk of z planes with a 3-plane ring of T in shared memory, which is what
// the TPU kernel does along z; nothing is recomputed along z but the two
// planes at a chunk's ends. At step j it computes T plane j on the tile plus
// a 1-voxel rim (10 x 32 positions: one T column per lane) and then output
// plane j - 1 from T planes j - 2 .. j. The alternative, a 3D output tile
// with conv1 recomputed on its halo, recomputes about 2x and needs a T tile
// of 130 KB; the ring needs 60 KB in bf16 (120 KB in f32) and recomputes
// conv1 1.25 x 1.07 x 1.125 (rows, columns, z chunk of 16).
//
// Both convs run on the CUDA cores' f32 FMA pipes like the training conv
// (convtrain.cu): a thread owns one column, 5 (conv1) or 4 (conv2) rows and 8
// output channels; the weights of 4 input channels at a time (f32, 13.5 KB)
// and, for conv1, the input halo of those channels (3 planes x 12 x 34) are
// staged in shared memory; conv2 reads its input straight from the T ring.
// ci = 1 stages and multiplies one channel, not four.
//
// What bounds it: operations. A (1, 64, 64, 160, 160) block is 136 G
// multiply-adds against ~0.3 GB of bf16 in and out, far above the card's
// ratio even for the CUDA cores. A tensor-core version (wgmma fed by TMA) is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

template <typename T>
struct Smem {
  float ws[kChunk][27][kCo];        // weights of the staged input channels
  float xs[kChunk][3][kXY][kXX];    // conv1's input halo of those channels
  T t[3][kCo][kTY][kLanes];         // ring of T planes, slot = plane mod 3
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
convblock_kernel(const T* __restrict__ x, const float* __restrict__ w1k,
                 const float* __restrict__ s1, const float* __restrict__ b1,
                 const float* __restrict__ w2k, const float* __restrict__ s2,
                 const float* __restrict__ b2, T* __restrict__ y, int ci, int D,
                 int H, int W, int z_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);

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
  const T* xn = x + static_cast<int64_t>(n) * ci * D * plane;
  T* yn = y + static_cast<int64_t>(n) * kCo * D * plane;

  for (int j = z0 - 1; j <= z1; ++j) {
    // conv2 of the previous step has read the ring slot this step overwrites
    __syncthreads();
    T(*tp)[kTY][kLanes] = sm.t[(j + 3) % 3];

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
            v = load_f32(xn + (static_cast<int64_t>(c0 + c) * D + gz) * plane +
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
          store(&tp[ch0 + o][row][lane],
                inside ? fmaxf(acc[r][o] * s + b, 0.f) : 0.f);
        }
      }
    } else {
      // T planes -1 and D are conv2's zero padding
      T* flat = &tp[0][0][0];
      for (int i = threadIdx.x; i < kCo * kTY * kLanes; i += kThreads)
        store(flat + i, 0.f);
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
          const T(*src)[kLanes] = sm.t[(z + 2 + kz) % 3][c0 + c];
          float in[kRows2 + 2][3];
#pragma unroll
          for (int r = 0; r < kRows2 + 2; ++r)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
              in[r][dx] = to_f32(src[rg * kRows2 + r][lx + dx]);
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
        T* out = yn + (static_cast<int64_t>(ch0 + o) * D + z) * plane + gx;
#pragma unroll
        for (int r = 0; r < kRows2; ++r) {
          const int gy = ty0 + rg * kRows2 + r;
          if (gy < H)
            store(out + static_cast<int64_t>(gy) * W,
                  fmaxf(acc[r][o] * s + b, 0.f));
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const float* w1k, const float* s1, const float* b1,
           const float* w2k, const float* s2, const float* b2, void* y, int N,
           int ci, int D, int H, int W, void* stream) {
  const int smem = static_cast<int>(sizeof(Smem<T>));
  // above 48 KB a kernel has to opt in to its dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      convblock_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int z_chunks = (D + kZChunk - 1) / kZChunk;
  const dim3 grid((W + kOutX - 1) / kOutX, (H + kOutY - 1) / kOutY,
                  N * z_chunks);
  convblock_kernel<T><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), w1k, s1, b1, w2k, s2, b2, static_cast<T*>(y),
      ci, D, H, W, z_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tpuseg

// y = relu(aff2(conv2(relu(aff1(conv1(x)))))). x: (N, ci, D, H, W), y: (N, 32,
// D, H, W), both bf16 (bf16 = 1) or f32 (bf16 = 0), contiguous; w1k: (ci, 27,
// 32) and w2k: (32, 27, 32) f32 holding values of the storage type, tap =
// (kd*3 + kh)*3 + kw; s*, b*: (32,) f32. The wrapper checks ceil(H/8) and
// N*ceil(D/16) <= 65535.
extern "C" int tpuseg_convblock(const void* x, const float* w1k,
                                const float* s1, const float* b1,
                                const float* w2k, const float* s2,
                                const float* b2, void* y, int N, int ci, int D,
                                int H, int W, int bf16, void* stream) {
  return bf16 ? tpuseg::launch<__nv_bfloat16>(x, w1k, s1, b1, w2k, s2, b2, y,
                                              N, ci, D, H, W, stream)
              : tpuseg::launch<float>(x, w1k, s1, b1, w2k, s2, b2, y, N, ci, D,
                                      H, W, stream);
}
