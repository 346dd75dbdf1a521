// U1 union_closure: the union-find closure of an edge list over a sorted key
// table, on the device and with no read by the host.
//
// It has no Pallas counterpart. It replaces the XLA closure of the JAX
// package (tpuseg/parallel/reconcile.py:41-78, tpuseg/ops/merge.py:136-152):
// scatter-min hooks and pointer jumps over the table for a fixed number of
// rounds, ceil(log2 m) + 1. Here the closure runs to its fixed point in two
// launches, whatever the graph's depth.
//
// The wrapper (ops/closure.py) builds the table with torch.sort and
// torch.searchsorted: `keys` (m slots, ascending, sentinel-padded), the
// endpoints' slots `pu`, `pv` (-1 for an inactive edge), and `parent`, where
// a repeated key's slot points at its first copy.
//
// (a) union_kernel, a thread per edge: both roots by path halving, then the
//     larger root is linked under the smaller with atomicCAS, retried from the
//     root's new parent when another thread linked it first. A link always
//     points to a smaller slot, so parent[i] <= i holds throughout, every
//     walk ends, and a group's root is its smallest slot: the smallest key
//     (slots are sorted by key) whatever the order the threads run in.
// (b) flatten_kernel, a thread per slot: parent[i] = root, reps[i] =
//     keys[root].
//
// Parents are read through volatile loads: L1 is not coherent across SMs,
// and a stale root read forever would spin a retry loop. Halving stores an
// ancestor over an ancestor, which is safe under any interleaving (parents
// only decrease, and only a root is ever CAS-linked).
//
// Bound: bytes. The wrapper's call reads u and v once and writes keys and
// reps once (each 4 or 8 bytes a slot); the walks and the CAS retries are
// latency-bound pointer chases, as in any union-find.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

__device__ __forceinline__ int find_root(int* parent, int x) {
  volatile int* p = parent;
  while (true) {
    const int px = p[x];
    if (px == x) return x;
    const int gx = p[px];
    if (gx == px) return px;
    p[x] = gx;  // path halving: x skips to its grandparent
    x = gx;
  }
}

__global__ void union_kernel(const int* __restrict__ pu,
                             const int* __restrict__ pv, long long e,
                             int* parent) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < e; i += step) {
    int a = pu[i];
    int b = pv[i];
    if (a < 0 || b < 0) continue;
    while (true) {
      a = find_root(parent, a);
      b = find_root(parent, b);
      if (a == b) break;
      const int hi = a > b ? a : b;
      const int lo = a > b ? b : a;
      const int old = atomicCAS(parent + hi, hi, lo);
      if (old == hi) break;
      a = old;  // hi was linked meanwhile: go on from its new parent
      b = lo;
    }
  }
}

template <typename K>
__global__ void flatten_kernel(int* parent, const K* __restrict__ keys,
                               K* __restrict__ reps, long long m) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < m; i += step) {
    const int r = find_root(parent, static_cast<int>(i));
    parent[i] = r;
    reps[i] = keys[r];
  }
}

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// pu, pv: e int32 slots (-1 inactive); parent: m int32 slots, closed in
// place; keys, reps: m keys of key_bytes (4 or 8) each. Returns a CUDA error
// code (0 on success).
extern "C" int tpuseg_union_closure(const void* pu, const void* pv,
                                    long long e, void* parent,
                                    const void* keys, void* reps, long long m,
                                    int key_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes != 4 && key_bytes != 8) return cudaErrorInvalidValue;
  if (e > 0) {
    union_kernel<<<blocks_for(e), kThreads, 0, s>>>(
        static_cast<const int*>(pu), static_cast<const int*>(pv), e,
        static_cast<int*>(parent));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (m > 0) {
    if (key_bytes == 4)
      flatten_kernel<int><<<blocks_for(m), kThreads, 0, s>>>(
          static_cast<int*>(parent), static_cast<const int*>(keys),
          static_cast<int*>(reps), m);
    else
      flatten_kernel<long long><<<blocks_for(m), kThreads, 0, s>>>(
          static_cast<int*>(parent), static_cast<const long long*>(keys),
          static_cast<long long*>(reps), m);
  }
  return cudaGetLastError();
}
