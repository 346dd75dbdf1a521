// InstanceNorm, residual add and LeakyReLU of SwinUNETR's ResBlocks in two
// passes (N1; no Pallas counterpart: the net is the port's alone).
//
// For a tensor `a` whose (n, c) planes of L voxels lie contiguous (NCDHW),
// with IN(t) = (t - mean) * (var + eps)^-1/2 over each plane (biased
// variance, no affine), it writes
//
//   out = lrelu(IN(a) + R),  R = 0 (mode 0), r (mode 1) or IN(r) (mode 2)
//
// (a ResBlock after conv1; conv2's output with the block's input; conv2's
// with conv3's), computed in float32 and rounded to the storage type once.
// Given a per-channel gamma and beta (float32; channel = plane % channels),
// IN(a) becomes IN(a) * gamma + beta: MedNeXt's GroupNorm of one group a
// channel, which it calls in mode 0 with slope 1 (the identity). Without
// them the kernels are the ones instantiated before the affine existed.
//
// What bounds it: bytes. A 96^3 block's ResBlocks hold ~290 M voxels, and
// torch's composition reads and writes each tensor 8 times (statistics,
// normalize, add, activation) where this reads a (and r) twice and writes
// once: mode 0 three passes, modes 1 and 2 five.
//
// Pass 1, instnorm_stats_kernel: one CTA for each chunk of `chunk` voxels of
// a plane (the last one ragged; blockIdx.x = plane * chunks + chunk, and
// blockIdx.z picks `a` or, in mode 2, `r`), so a 96^3 plane splits into 54
// CTAs and a 3^3 plane is one. A thread reads 16-byte vectors of its chunk
// (v = t, t + 256, ... in order; a plane whose start is not 16-byte aligned
// gives its first and last few voxels to threads 0.. as scalars, before and
// after the vectors), takes each vector's count, mean and M2 exactly (its
// sum in order, the mean, the squares of the deviations summed in order)
// and merges it into its own by Chan's rule; the CTA merges its threads'
// in a fixed tree (warp shuffles down from 16, then the 8 warps from 4) and
// writes one partial (count, mean, M2) for its chunk.
// Pass 2, instnorm_apply_kernel: the same CTAs over `a`; warp 0 (and warp 1
// for r in mode 2) merges the plane's partials in a fixed order (lane l the
// chunks l, l + 32, ..., then the shuffle tree) into the mean and 1 /
// sqrt(var + eps), and the CTA writes its chunk in 16-byte vectors.
//
// No atomics, and every merge in a fixed order: the same input gives the
// same bits on every call, captured or eager. Every float operation is an
// explicit round-to-nearest intrinsic, so no multiply-add is contracted and
// the model in tests/test_torch_instnorm.py repeats the arithmetic op for op.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpuseg {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;            // vectors a thread has in flight

struct Stat {
  float n, m, q;                      // count, mean, sum of squared deviations
};

// Chan's merge of b into a; an empty b leaves a as it is, and a merge into
// an empty a copies b exactly.
__device__ __forceinline__ void merge(Stat& a, const Stat& b) {
  if (b.n == 0.f) return;
  const float n = __fadd_rn(a.n, b.n);
  const float d = __fsub_rn(b.m, a.m);
  const float f = __fdiv_rn(b.n, n);
  a.m = __fadd_rn(a.m, __fmul_rn(d, f));
  a.q = __fadd_rn(__fadd_rn(a.q, b.q),
                  __fmul_rn(__fmul_rn(__fmul_rn(d, d), a.n), f));
  a.n = n;
}

__device__ __forceinline__ Stat shfl_down(const Stat& s, int off) {
  return {__shfl_down_sync(0xffffffffu, s.n, off),
          __shfl_down_sync(0xffffffffu, s.m, off),
          __shfl_down_sync(0xffffffffu, s.q, off)};
}

// lane 0 ends with the merge of the first `width` lanes (a power of two)
__device__ __forceinline__ void tree_merge(Stat& s, int width) {
  for (int off = width / 2; off > 0; off >>= 1) merge(s, shfl_down(s, off));
}

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  using Raw = float4;
  __device__ static void unpack(const Raw& r, float (&x)[kN]) {
    x[0] = r.x;
    x[1] = r.y;
    x[2] = r.z;
    x[3] = r.w;
  }
  __device__ static Raw pack(const float (&x)[kN]) {
    return make_float4(x[0], x[1], x[2], x[3]);
  }
  __device__ static float scalar(float v) { return v; }
  __device__ static float store(float v) { return v; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Raw = uint4;
  __device__ static void unpack(const Raw& r, float (&x)[kN]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      x[2 * j] = f.x;
      x[2 * j + 1] = f.y;
    }
  }
  __device__ static Raw pack(const float (&x)[kN]) {
    Raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    return r;
  }
  __device__ static float scalar(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  __device__ static __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

// A CTA's share of a plane: its first element's index in the tensor, and
// its voxels as `head` scalars, `nv` vectors and `tail` scalars.
struct Span {
  long long g0;
  int head, nv, tail;
};

template <int V>
__device__ __forceinline__ Span chunk_span(long long plane, int c,
                                           long long L, int chunk) {
  Span s;
  const long long start = static_cast<long long>(c) * chunk;
  const int n = static_cast<int>(min(static_cast<long long>(chunk),
                                     L - start));
  s.g0 = plane * L + start;
  s.head = min(static_cast<int>((V - s.g0 % V) % V), n);
  s.nv = (n - s.head) / V;
  s.tail = n - s.head - s.nv * V;
  return s;
}

template <typename T>
__device__ __forceinline__ Stat vector_stat(const typename Pack<T>::Raw& r) {
  constexpr int V = Pack<T>::kN;
  float x[V];
  Pack<T>::unpack(r, x);
  float s = x[0];
#pragma unroll
  for (int j = 1; j < V; ++j) s = __fadd_rn(s, x[j]);
  const float m = __fmul_rn(s, 1.0f / V);
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = __fsub_rn(x[j], m);
    q = __fadd_rn(q, __fmul_rn(d, d));
  }
  return {static_cast<float>(V), m, q};
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
instnorm_stats_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      float4* __restrict__ part, long long planes,
                      long long L, int chunk, int chunks) {
  using P = Pack<T>;
  using Raw = typename P::Raw;
  __shared__ Stat warps[kWarps];
  const long long plane = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks, t = threadIdx.x;
  const Span sp = chunk_span<P::kN>(plane, c, L, chunk);
  const T* x = (blockIdx.z ? b : a) + sp.g0;
  const Raw* xv = reinterpret_cast<const Raw*>(x + sp.head);

  Stat s{0.f, 0.f, 0.f};
  if (t < sp.head) merge(s, {1.f, P::scalar(x[t]), 0.f});
  for (int v0 = t; v0 < sp.nv; v0 += kThreads * kUnroll) {
    Raw buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v < sp.nv) buf[u] = __ldg(xv + v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v0 + u * kThreads < sp.nv) merge(s, vector_stat<T>(buf[u]));
  }
  if (t < sp.tail)
    merge(s, {1.f, P::scalar(x[sp.head + sp.nv * P::kN + t]), 0.f});

  tree_merge(s, 32);
  const int warp = t >> 5, lane = t & 31;
  if (lane == 0) warps[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? warps[lane] : Stat{0.f, 0.f, 0.f};
    tree_merge(s, kWarps);
    if (lane == 0)
      part[(blockIdx.z * planes + plane) * chunks + c] =
          make_float4(s.n, s.m, s.q, 0.f);
  }
}

template <int MODE, bool AFFINE>
__device__ __forceinline__ float norm_add_act(float a, float r,
                                              const float (&k)[6],
                                              float slope) {
  float y = __fmul_rn(__fsub_rn(a, k[0]), k[1]);
  if (AFFINE) y = __fadd_rn(__fmul_rn(y, k[4]), k[5]);
  if (MODE == 1) y = __fadd_rn(y, r);
  if (MODE == 2) y = __fadd_rn(y, __fmul_rn(__fsub_rn(r, k[2]), k[3]));
  return y > 0.f ? y : __fmul_rn(y, slope);
}

template <typename T, int MODE, bool AFFINE>
__global__ void __launch_bounds__(kThreads)
instnorm_apply_kernel(const T* __restrict__ a, const T* __restrict__ r,
                      const float4* __restrict__ part, T* __restrict__ out,
                      long long planes, long long L, int chunk, int chunks,
                      float eps, float slope, const float* __restrict__ gamma,
                      const float* __restrict__ beta, int channels) {
  using P = Pack<T>;
  using Raw = typename P::Raw;
  constexpr int V = P::kN;
  // mean and 1 / sqrt(var + eps) of a, then of r; gamma and beta
  __shared__ float coef[6];
  const long long plane = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  if (warp < (MODE == 2 ? 2 : 1)) {
    const float4* pp = part + (warp * planes + plane) * chunks;
    Stat s{0.f, 0.f, 0.f};
    for (int k = lane; k < chunks; k += 32) {
      const float4 v = pp[k];
      merge(s, {v.x, v.y, v.z});
    }
    tree_merge(s, 32);
    if (lane == 0) {
      coef[2 * warp] = s.m;
      coef[2 * warp + 1] =
          __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(s.q, s.n), eps)));
      if (AFFINE && warp == 0) {
        const int ch = static_cast<int>(plane % channels);
        coef[4] = gamma[ch];
        coef[5] = beta[ch];
      }
    }
  }
  __syncthreads();
  const float k[6] = {coef[0], coef[1], coef[2], coef[3],
                      AFFINE ? coef[4] : 0.f, AFFINE ? coef[5] : 0.f};

  const Span sp = chunk_span<V>(plane, c, L, chunk);
  const T* xa = a + sp.g0;
  const T* xr = MODE ? r + sp.g0 : nullptr;
  T* xo = out + sp.g0;
  auto one = [&](int i) {
    xo[i] = P::store(norm_add_act<MODE, AFFINE>(
        P::scalar(xa[i]), MODE ? P::scalar(xr[i]) : 0.f, k, slope));
  };
  if (t < sp.head) one(t);
  if (t < sp.tail) one(sp.head + sp.nv * V + t);
  const Raw* va = reinterpret_cast<const Raw*>(xa + sp.head);
  const Raw* vr = MODE ? reinterpret_cast<const Raw*>(xr + sp.head) : nullptr;
  Raw* vo = reinterpret_cast<Raw*>(xo + sp.head);
  for (int v0 = t; v0 < sp.nv; v0 += kThreads * kUnroll) {
    Raw ba[kUnroll], br[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v < sp.nv) {
        ba[u] = __ldg(va + v);
        if (MODE) br[u] = __ldg(vr + v);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v >= sp.nv) continue;
      float x[V], y[V];
      P::unpack(ba[u], x);
      if (MODE) P::unpack(br[u], y);
#pragma unroll
      for (int j = 0; j < V; ++j)
        x[j] = norm_add_act<MODE, AFFINE>(x[j], MODE ? y[j] : 0.f, k, slope);
      vo[v] = P::pack(x);
    }
  }
}

template <typename T>
int launch_stats(const void* a, const void* b, void* part, long long planes,
                 long long L, int chunk, int chunks, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(planes * chunks), 1, b ? 2 : 1);
  instnorm_stats_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float4*>(part), planes, L, chunk, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool AFFINE>
void launch_apply_mode(const T* pa, const T* pr, const float4* pp, T* po,
                       long long planes, long long L, int chunk, int chunks,
                       int mode, float eps, float slope, const float* g,
                       const float* b, int channels, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(planes * chunks);
  if (mode == 0)
    instnorm_apply_kernel<T, 0, AFFINE><<<grid, kThreads, 0, st>>>(
        pa, pr, pp, po, planes, L, chunk, chunks, eps, slope, g, b, channels);
  else if (mode == 1)
    instnorm_apply_kernel<T, 1, AFFINE><<<grid, kThreads, 0, st>>>(
        pa, pr, pp, po, planes, L, chunk, chunks, eps, slope, g, b, channels);
  else
    instnorm_apply_kernel<T, 2, AFFINE><<<grid, kThreads, 0, st>>>(
        pa, pr, pp, po, planes, L, chunk, chunks, eps, slope, g, b, channels);
}

template <typename T>
int launch_apply(const void* a, const void* r, const void* part, void* out,
                 long long planes, long long L, int chunk, int chunks,
                 int mode, float eps, float slope, const float* g,
                 const float* b, int channels, cudaStream_t st) {
  const T* pa = static_cast<const T*>(a);
  const T* pr = static_cast<const T*>(r);
  const float4* pp = static_cast<const float4*>(part);
  T* po = static_cast<T*>(out);
  if (g)
    launch_apply_mode<T, true>(pa, pr, pp, po, planes, L, chunk, chunks,
                               mode, eps, slope, g, b, channels, st);
  else
    launch_apply_mode<T, false>(pa, pr, pp, po, planes, L, chunk, chunks,
                                mode, eps, slope, g, b, channels, st);
  return static_cast<int>(cudaGetLastError());
}

// the number of chunks of a plane, or -1 where the arguments are refused
// (counts are float32: a plane holds at most 2^24 voxels)
int chunk_count(long long planes, long long L, int chunk, int elem_bytes) {
  if (planes < 1 || L < 1 || L > (1LL << 24) || chunk < 8 ||
      chunk % 8 != 0 || (elem_bytes != 2 && elem_bytes != 4))
    return -1;
  const long long chunks = (L + chunk - 1) / chunk;
  if (planes * chunks >= (1LL << 31)) return -1;
  return static_cast<int>(chunks);
}

}  // namespace
}  // namespace tpuseg

// part (1 + (b != null), planes, chunks, 4) float32 <- each chunk's count,
// mean and M2 of `a` (and of `b`): planes of L voxels, 2-byte (bf16) or
// 4-byte (float32) elements, 16-byte aligned.
extern "C" int tpuseg_instnorm_stats(const void* a, const void* b, void* part,
                                     long long planes, long long L, int chunk,
                                     int elem_bytes, void* stream) {
  using namespace tpuseg;
  const int chunks = chunk_count(planes, L, chunk, elem_bytes);
  if (chunks < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elem_bytes == 2
             ? launch_stats<__nv_bfloat16>(a, b, part, planes, L, chunk,
                                           chunks, st)
             : launch_stats<float>(a, b, part, planes, L, chunk, chunks, st);
}

// out = lrelu(IN(a) * gamma + beta + R) (mode 0: R = 0; 1: R = r; 2: R =
// IN(r); gamma and beta of `channels` channels, both null for none) from
// the partials tpuseg_instnorm_stats wrote with the same planes, L and chunk.
extern "C" int tpuseg_instnorm_apply(const void* a, const void* r,
                                     const void* part, void* out,
                                     long long planes, long long L, int chunk,
                                     int mode, int elem_bytes, float eps,
                                     float slope, const void* gamma,
                                     const void* beta, int channels,
                                     void* stream) {
  using namespace tpuseg;
  const int chunks = chunk_count(planes, L, chunk, elem_bytes);
  if (chunks < 0 || mode < 0 || mode > 2 || (mode != 0 && r == nullptr) ||
      (gamma == nullptr) != (beta == nullptr) ||
      (gamma != nullptr && channels < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  return elem_bytes == 2
             ? launch_apply<__nv_bfloat16>(a, r, part, out, planes, L, chunk,
                                           chunks, mode, eps, slope, g, b,
                                           channels, st)
             : launch_apply<float>(a, r, part, out, planes, L, chunk, chunks,
                                   mode, eps, slope, g, b, channels, st);
}
