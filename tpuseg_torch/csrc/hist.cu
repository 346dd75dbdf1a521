// H1-H3: the histograms of one-volume inference, on the device and with no
// read by the host.
//
// These have no Pallas counterpart. They replace work that the JAX package
// leaves to XLA (tpuseg/data/normalize.py:59-63: the percentile histogram and
// its float32 CDF; tpuseg/ops/calibrate.py: the calibration histogram;
// tpuseg/ops/filter.py:60-64 and :117: the (N+1,) label histogram), where
// the stock PyTorch op (torch.bincount, torch.unique) reads the size of its
// output on the host before it launches.
//
// H1 bin_counts: (B, n) float32 rows -> (B, bins) int64 counts. Each block
//   keeps a histogram of its own in shared memory (bins x 4 B), and adds it
//   to the row's global counts at the end: one atomic per nonzero bin per
//   block. Lanes of a warp that fall in the same bin (most voxels of an
//   image's background, of a probability map's zero) are merged first
//   (__match_any_sync), so a bin's shared atomics do not serialize a warp.
//   The bin index is the float32 one of the plain version, each rounding
//   written out (__fsub_rn, __fdiv_rn, __fmul_rn: under nvcc's default
//   -fmad=true a product and a sum may otherwise fuse into one FMA):
//     rule 0 (normalization):  (x - lo) / span * bins
//     rule 1 (calibration):    x * bins
//   truncated toward zero and clamped to [0, bins - 1].
//   Bound: bytes, 4 per sample read once.
//
// H2 percentiles: (B, bins) counts -> (P, B) float32 percentile values, bit
//   equal to numpy's float32 cumsum + searchsorted(side="left"): one block a
//   row converts the counts to float32 fractions in parallel (each is a
//   round of its own), then one thread adds them in bin order, as numpy's
//   sequential cumsum does (a parallel scan rounds in another order, and a
//   count passes 2^24 at 96x512x512). A target no CDF entry reaches gives
//   k = bins, as searchsorted does. Bound: the 4096-step dependent float32
//   add chain, about 4 cycles a step, not the 32 KB it reads; the scan stops
//   at the bin where the last target is reached.
//
// H3 label_counts: int32 labels in 0..N -> (N+1,) int32 counts with label 0
//   skipped (it is the background, most of the voxels, and would put one
//   atomic per voxel on one address). Voxels of one instance lie together,
//   so a warp's lanes of one label are merged first (__match_any_sync) and
//   add once. Labels outside 1..N are not counted. Bound: bytes, 4 per voxel
//   read, the table's writes scattered.
#include <cuda_runtime.h>

namespace {

constexpr int kHistThreads = 256;
constexpr int kMaxBins = 4096;
constexpr int kMaxPcts = 8;

// the percentile targets, by value: a kernel parameter, no copy to the device
struct Targets {
  float t[kMaxPcts];
};

__device__ __forceinline__ int bin_of(float x, float lo, float span, int bins,
                                      int rule) {
  const float fb = static_cast<float>(bins);
  const float t = rule == 0 ? __fmul_rn(__fdiv_rn(__fsub_rn(x, lo), span), fb)
                            : __fmul_rn(x, fb);
  // truncation toward zero, then the clamp; NaN falls to bin 0 as in torch
  // (its int64 cast gives INT64_MIN)
  if (t >= fb) return bins - 1;
  return t >= 1.0f ? static_cast<int>(t) : 0;
}

__global__ void bin_counts_kernel(const float* __restrict__ x, long long n,
                                  const float* __restrict__ lo,
                                  const float* __restrict__ span, int bins,
                                  int rule,
                                  unsigned long long* __restrict__ counts) {
  __shared__ unsigned s_hist[kMaxBins];
  const int row = blockIdx.y;
  for (int b = threadIdx.x; b < bins; b += blockDim.x) s_hist[b] = 0;
  __syncthreads();
  const float l = rule == 0 ? lo[row] : 0.0f;
  const float s = rule == 0 ? span[row] : 1.0f;
  const float* xr = x + row * n;
  const unsigned lane = threadIdx.x & 31u;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  // a warp's lanes run the same trips: the bound is the warp's first index
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                        (threadIdx.x & ~31u);
       base < n; base += step) {
    const long long i = base + lane;
    const int k = i < n ? bin_of(xr[i], l, s, bins, rule) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    if (k >= 0 && lane == static_cast<unsigned>(__ffs(peers) - 1))
      atomicAdd(&s_hist[k], static_cast<unsigned>(__popc(peers)));
  }
  __syncthreads();
  unsigned long long* out = counts + static_cast<long long>(row) * bins;
  for (int b = threadIdx.x; b < bins; b += blockDim.x)
    if (s_hist[b] != 0) atomicAdd(out + b, s_hist[b]);
}

// P targets a template parameter: k[] and t[] stay in registers, and the
// scan's one thread runs 1 + 2P instructions a bin beside the add chain.
template <int P>
__global__ void percentiles_kernel(const long long* __restrict__ counts,
                                   int bins, long long n,
                                   const float* __restrict__ lo,
                                   const float* __restrict__ span,
                                   Targets targets, int B,
                                   float* __restrict__ out) {
  __shared__ float s_frac[kMaxBins];
  const int row = blockIdx.x;
  const float nf = __ll2float_rn(n);
  const long long* c = counts + static_cast<long long>(row) * bins;
  for (int b = threadIdx.x; b < bins; b += blockDim.x)
    s_frac[b] = __fdiv_rn(__ll2float_rn(c[b]), nf);
  __syncthreads();
  if (threadIdx.x != 0) return;
  float t[P];
  int k[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    t[j] = targets.t[j];
    k[j] = bins;
  }
  float cdf = 0.0f;
  for (int b0 = 0; b0 < bins; b0 += 8) {
    float f[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) f[u] = b0 + u < bins ? s_frac[b0 + u] : 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (b0 + u >= bins) break;
      cdf = __fadd_rn(cdf, f[u]);
#pragma unroll
      for (int j = 0; j < P; ++j)
        if (k[j] == bins && cdf >= t[j]) k[j] = b0 + u;
    }
    bool done = true;
#pragma unroll
    for (int j = 0; j < P; ++j) done = done && k[j] != bins;
    if (done) break;
  }
  const float fb = static_cast<float>(bins);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float mid = __fdiv_rn(__fadd_rn(static_cast<float>(k[j]), 0.5f), fb);
    out[j * B + row] = __fadd_rn(lo[row], __fmul_rn(mid, span[row]));
  }
}

__global__ void label_counts_kernel(const int* __restrict__ labels,
                                    long long n, int* __restrict__ counts) {
  const unsigned lane = threadIdx.x & 31u;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                        (threadIdx.x & ~31u);
       base < n; base += step) {
    const long long i = base + lane;
    int v = i < n ? labels[i] : 0;
    if (v < 0 || v > n) v = 0;
    const unsigned peers = __match_any_sync(0xffffffffu, v);
    if (v != 0 && lane == static_cast<unsigned>(__ffs(peers) - 1))
      atomicAdd(counts + v, __popc(peers));
  }
}

// blocks for a grid-stride loop over n items: enough to fill the card
int stride_blocks(long long n, int rows) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (8LL * sms + rows - 1) / rows;
  const long long need = (n + kHistThreads - 1) / kHistThreads;
  return static_cast<int>(need < want ? (need > 0 ? need : 1) : want);
}

}  // namespace

// counts (B, bins) int64, zeroed by the caller, += the histogram of each
// contiguous row of x (B, n) float32 under `rule` (0: between the row's
// lo[b] and lo[b] + span[b]; 1: of [0, 1], lo and span unused). bins <= 4096.
extern "C" int tpuseg_bin_counts(const float* x, long long n, int B,
                                 const float* lo, const float* span, int bins,
                                 int rule, long long* counts, void* stream) {
  if (bins < 1 || bins > kMaxBins || B < 1 || B > 65535 || rule < 0 ||
      rule > 1)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const dim3 grid(stride_blocks(n, B), B);
  bin_counts_kernel<<<grid, kHistThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, n, lo, span, bins, rule,
      reinterpret_cast<unsigned long long*>(counts));
  return cudaGetLastError();
}

// out (P, B) float32: lo + (k + 0.5) / bins * span with k the first bin whose
// float32 CDF (counts / n, summed in bin order) reaches targets[j]. The P
// <= 8 float32 targets lie in host memory and reach the kernel by value.
extern "C" int tpuseg_percentiles(const long long* counts, int B, int bins,
                                  long long n, const float* lo,
                                  const float* span, const float* targets,
                                  int P, float* out, void* stream) {
  if (bins < 1 || bins > kMaxBins || B < 1 || P < 1 || P > kMaxPcts)
    return cudaErrorInvalidValue;
  Targets t{};
  for (int j = 0; j < P; ++j) t.t[j] = targets[j];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
#define TPUSEG_PCTS(NP)                                                     \
  case NP:                                                                  \
    percentiles_kernel<NP><<<B, kHistThreads, 0, st>>>(counts, bins, n, lo, \
                                                       span, t, B, out);    \
    break;
    TPUSEG_PCTS(1) TPUSEG_PCTS(2) TPUSEG_PCTS(3) TPUSEG_PCTS(4)
    TPUSEG_PCTS(5) TPUSEG_PCTS(6) TPUSEG_PCTS(7) TPUSEG_PCTS(8)
#undef TPUSEG_PCTS
  }
  return cudaGetLastError();
}

// counts (n + 1,) int32, zeroed by the caller, += the number of voxels of
// each label 1..n in `labels` (n int32 values); label 0 and labels outside
// 0..n are not counted.
extern "C" int tpuseg_label_counts(const int* labels, long long n,
                                   int* counts, void* stream) {
  if (n == 0) return cudaSuccess;
  label_counts_kernel<<<stride_blocks(n, 1), kHistThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(labels, n,
                                                             counts);
  return cudaGetLastError();
}
