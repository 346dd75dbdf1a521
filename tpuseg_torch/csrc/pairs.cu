// M1 pair_aggregate and M2 pair_slots: the saddle merge's per-axis pair
// table (the distinct adjacent label pairs of each axis, each with its
// saddle, in the reference's slot layout), on the device, with no host read
// and no sort of a volume-sized array.
//
// They replace the XLA code of tpuseg/ops/merge.py:57-123
// (saddle_merge_edges): there, per axis, every voxel's pair key is sorted
// with its saddle, the runs' ends are compacted by a second sort into
// max_pairs slots, and the slots are tested against the basins' maxima.
// There is no Pallas kernel for it. The port's plain twin
// (ops/merge.saddle_merge_axis_edges_plain) sorts the whole volume's int64
// keys on each axis, as the reference does.
//
// Along an axis, a face is a voxel pair (v, v + 1) with both labels > 0 and
// unequal; its key is lo << 31 | hi (lo < hi, so lo >= 1 and no key is 0,
// the empty slot's value) and its value min(peak(v), peak(v + 1)) in
// float32. A pair's saddle is the largest value over its faces.
//
// M1 (tpuseg_pair_aggregate: three kernels):
// (a) face_count_kernel: each axis's face count F_a, one pass over the
//     labels. Axis a's hash table then has C_a = min(2 F_a + 1, A_a) slots,
//     A_a the face positions + 1 the wrapper allocated: C_a > F_a >= P_a
//     (the distinct pairs), so an insert always finds a free slot, and the
//     load stays at most one half while the faces fit 2 F_a + 1 slots.
//     Clearing and reading the table cost what the faces need, not the
//     volume.
// (b) table_clear_kernel: zeroes the C_a slots of every axis.
// (c) pair_insert_kernel: one pass over the labels again; each face's key
//     goes into its axis's open-addressing table (linear probing from a
//     mixing hash: labels are root linear indices + 1, so raw keys are
//     clustered) by atomicCAS, and its value into the slot's saddle by
//     atomicMax on the float's order-preserving bits. A warp with no face
//     on an axis skips it; the lanes of a warp that hold one key first
//     combine (__match_any_sync, __reduce_max_sync), so an interface costs
//     one insert per warp, not one per voxel. The thread whose CAS claims a
//     slot counts the axis's distinct pairs P_a and, while P_a <= S,
//     appends the key and its slot to the axis's S-entry buffer.
//
// M2 (tpuseg_pair_select, the wrapper's torch.sort of the (3, S) buffer,
// tpuseg_pair_slots):
// (d) select_pass_kernel x 4, gated: an axis with P_a > S (its buffer holds
//     only some of its pairs) finds its max_pairs-th smallest key by a radix
//     select over its table, 16 bits a pass: a histogram of the digit among
//     the keys that share the prefix so far; the last block to finish picks
//     the digit. An axis with P_a <= S returns at once.
// (e) select_keep_kernel, gated the same way: the keys at or below that key
//     (exactly max_pairs of them) refill the buffer, the rest of it empty.
// The wrapper sorts the (3, S) buffers (max_pairs-sized, not volume-sized).
// (f) pair_slots_kernel: slot i of axis a holds the i-th smallest pair if it
//     passes saddle >= float32(ratio) * min(basin[lo - 1], basin[hi - 1])
//     (indices clamped into basin), SENT otherwise; dropped[a] =
//     max(P_a - max_pairs, 0).
// M2's select state (prefix, ranks, tickets, histograms) is its own, zeroed
// by its wrapper, so M2 may run again on one table with the same result.
//
// Every output is a count, a key or a float maximum, so the result does not
// depend on the order in which the atomics land: it equals the twin's
// elementwise. Which slot a key lands in does depend on it, and nothing
// reads that order (the buffer is sorted).
//
// The labels and the peaks come with their strides (elements), so the
// sharded paths' grown cores (views of a slab that are not contiguous) are
// read in place: per axis a, the region is the labels' full extent along a
// and core[d] along every other dim d. The peaks are read in their own
// dtype (float32, bfloat16 or float16; both convert exactly).
//
// Bound: bytes. M1 must read the labels and the peaks once and write the
// P_a pairs (12 B each); (a) and (c) each read the labels (the +1
// neighbours come from L1 and L2), and the table traffic is 12 B a slot of
// 2 F_a + 1. M2 reads the P_a pairs and writes 3 max_pairs slots.
//
// The tables are read and written by atomics only, which L2 serves, so no
// probe reads a slot from another SM through a stale L1 line; the
// histograms of (d) are read by the last block with ld.global.cg after the
// other blocks' __threadfence.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;          // M1: a row segment a block step
constexpr int kSelectThreads = 256;    // (b), (d), (e), (f)
constexpr long long kMaxBlocks = 4096;
// (b), (d), (e) stride over a table with 4 blocks an SM: a gated launch that
// returns at once costs a few microseconds, not the ~0.1 ms of 4096 x 3
// blocks
constexpr long long kSweepBlocks = 4 * 132;
constexpr int kDigitBits = 16;
constexpr int kBins = 1 << kDigitBits;
constexpr int kPasses = 64 / kDigitBits;
constexpr long long kEmptyBuffer = 0x7fffffffffffffffLL;  // sorts last
constexpr int kSent = 0x7fffffff;

// M1's int64 counts (ops/merge.py: _M1_WORDS)
enum : int { kFaces = 0, kPairs = 3 };
// M2's int64 select state (ops/merge.py: _M2_WORDS), then three histograms
// of kBins uint32 bins
enum : int {
  kRankDone = 0,  // [3] (d): keys below the prefix, counted so far
  kPrefix = 3,    // [3] (d): the selected key's digits so far
  kTicket = 6,    // [3] (d): blocks done in this pass
  kKept = 9,      // [3] (e): keys refilled into the buffer
  kSelWords = 12,
};

struct Geo {
  int n[3];            // the labels' (and peaks') extents
  long long ls[3];     // the labels' strides, elements
  long long ps[3];     // the peaks' strides, elements
  int core[3];         // the region's extent along d for the axes a != d
  long long off[3];    // axis a's first table slot
  long long alloc[3];  // A_a: axis a's allocated slots
};

__device__ __forceinline__ float load_float(const void* p, int dtype,
                                            long long i) {
  if (dtype == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dtype == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// float32 -> uint32 with the same order (for atomicMax), and back
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// splitmix64's finalizer; the top 32 bits pick the home slot in [0, cap)
__device__ __forceinline__ long long home_slot(unsigned long long key,
                                               long long cap) {
  key ^= key >> 33;
  key *= 0xff51afd7ed558ccdULL;
  key ^= key >> 33;
  key *= 0xc4ceb9fe1a85ec53ULL;
  key ^= key >> 33;
  return static_cast<long long>(
      ((key >> 32) * static_cast<unsigned long long>(cap)) >> 32);
}

__device__ __forceinline__ long long capacity(const long long* meta,
                                              const Geo& g, int a) {
  const long long c = 2 * meta[kFaces + a] + 1;
  return c < g.alloc[a] ? c : g.alloc[a];
}

// Whether row (z, y) lies in axis a's region (its x test is x_ok's).
__device__ __forceinline__ bool row_ok(const Geo& g, int a, int z, int y) {
  const int v[2] = {z, y};
  for (int d = 0; d < 2; ++d) {
    const int lim = d == a ? g.n[d] - 1 : g.core[d];
    if (v[d] >= lim) return false;
  }
  return true;
}

__device__ __forceinline__ bool x_ok(const Geo& g, int a, int x) {
  return x < (a == 2 ? g.n[2] - 1 : g.core[2]);
}

int row_blocks(const Geo& g) {
  const long long rows = static_cast<long long>(g.n[0]) * g.n[1];
  return static_cast<int>(rows < kMaxBlocks ? rows : kMaxBlocks);
}

// (a) Each block walks rows (z, y) of the labels, kThreads x positions a
// step; each axis's faces are summed in registers, then once a block.
__global__ void __launch_bounds__(kThreads)
face_count_kernel(const int* __restrict__ lab, Geo g, long long* meta) {
  long long count[3] = {0, 0, 0};
  const long long rows = static_cast<long long>(g.n[0]) * g.n[1];
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const int z = static_cast<int>(r / g.n[1]);
    const int y = static_cast<int>(r - static_cast<long long>(z) * g.n[1]);
    bool rok[3];
    for (int a = 0; a < 3; ++a) rok[a] = row_ok(g, a, z, y);
    const long long base = z * g.ls[0] + y * g.ls[1];
    for (int x = threadIdx.x; x < g.n[2]; x += kThreads) {
      const long long i = base + static_cast<long long>(x) * g.ls[2];
      const int a0 = lab[i];
      if (a0 <= 0) continue;
      for (int a = 0; a < 3; ++a) {
        if (!rok[a] || !x_ok(g, a, x)) continue;
        const int b = lab[i + g.ls[a]];
        count[a] += b > 0 && b != a0;
      }
    }
  }
  __shared__ unsigned long long sum[3];
  if (threadIdx.x < 3) sum[threadIdx.x] = 0;
  __syncthreads();
  for (int a = 0; a < 3; ++a) {
    unsigned long long c = count[a];
    for (int s = 16; s > 0; s >>= 1) c += __shfl_down_sync(0xffffffffu, c, s);
    if ((threadIdx.x & 31) == 0 && c) atomicAdd(sum + a, c);
  }
  __syncthreads();
  if (threadIdx.x < 3 && sum[threadIdx.x])
    atomicAdd(reinterpret_cast<unsigned long long*>(meta + kFaces) +
                  threadIdx.x,
              sum[threadIdx.x]);
}

// (b) blockIdx.y: the axis
__global__ void __launch_bounds__(kSelectThreads)
table_clear_kernel(Geo g, unsigned long long* keys, unsigned* saddles,
                   const long long* meta) {
  const int a = blockIdx.y;
  const long long cap = capacity(meta, g, a);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cap; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    keys[g.off[a] + i] = 0;
    saddles[g.off[a] + i] = 0;
  }
}

// Insert `key` with saddle bits `s` into axis a's table of `cap` slots.
__device__ void insert_pair(unsigned long long* keys, unsigned* saddles,
                            long long cap, unsigned long long key, unsigned s,
                            unsigned long long* pairs, long long* buf_keys,
                            int* buf_slots, long long S) {
  long long h = home_slot(key, cap);
  while (true) {
    const unsigned long long old = atomicCAS(keys + h, 0ULL, key);
    if (old == 0) {  // claimed: a new pair
      const unsigned long long idx = atomicAdd(pairs, 1ULL);
      if (idx < static_cast<unsigned long long>(S)) {
        buf_keys[idx] = static_cast<long long>(key);
        buf_slots[idx] = static_cast<int>(h);
      }
      break;
    }
    if (old == key) break;
    if (++h == cap) h = 0;
  }
  atomicMax(saddles + h, s);
}

// (c) The rows as in (a); every lane of a warp reaches the warp votes (the
// loops' bounds are the block's), a lane off a face with key 0.
__global__ void __launch_bounds__(kThreads)
pair_insert_kernel(const int* __restrict__ lab, const void* __restrict__ pk,
                   int pk_dtype, Geo g, unsigned long long* keys,
                   unsigned* saddles, long long* meta, long long* buf_keys,
                   int* buf_slots, long long S) {
  long long cap[3];
  for (int a = 0; a < 3; ++a) cap[a] = capacity(meta, g, a);
  unsigned long long* pairs =
      reinterpret_cast<unsigned long long*>(meta + kPairs);
  const int lane = threadIdx.x & 31;
  const long long rows = static_cast<long long>(g.n[0]) * g.n[1];
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const int z = static_cast<int>(r / g.n[1]);
    const int y = static_cast<int>(r - static_cast<long long>(z) * g.n[1]);
    bool rok[3];
    for (int a = 0; a < 3; ++a) rok[a] = row_ok(g, a, z, y);
    const long long lbase = z * g.ls[0] + y * g.ls[1];
    const long long pbase = z * g.ps[0] + y * g.ps[1];
    for (int x0 = 0; x0 < g.n[2]; x0 += kThreads) {
      const int x = x0 + threadIdx.x;
      const bool inside = x < g.n[2];
      const long long i = lbase + static_cast<long long>(x) * g.ls[2];
      const long long j = pbase + static_cast<long long>(x) * g.ps[2];
      const int a0 = inside ? lab[i] : 0;
      bool have_p0 = false;
      float p0 = 0.f;
      for (int a = 0; a < 3; ++a) {
        unsigned long long key = 0;
        unsigned s = 0;
        if (a0 > 0 && rok[a] && x_ok(g, a, x)) {
          const int b = lab[i + g.ls[a]];
          if (b > 0 && b != a0) {
            if (!have_p0) {
              p0 = load_float(pk, pk_dtype, j);
              have_p0 = true;
            }
            const float p1 = load_float(pk, pk_dtype, j + g.ps[a]);
            const unsigned lo = a0 < b ? a0 : b, hi = a0 < b ? b : a0;
            key = static_cast<unsigned long long>(lo) << 31 | hi;
            s = ordered(fminf(p0, p1));
          }
        }
        if (!__any_sync(0xffffffffu, key != 0)) continue;  // warp-uniform
        const unsigned group = __match_any_sync(0xffffffffu, key);
        const unsigned smax = __reduce_max_sync(group, s);
        if (key != 0 && lane == __ffs(group) - 1)
          insert_pair(keys + g.off[a], saddles + g.off[a], cap[a], key, smax,
                      pairs + a, buf_keys + a * S, buf_slots + a * S, S);
      }
    }
  }
}

// (d) One radix-select pass (digit `pass`, most significant first) over
// axis blockIdx.y's table, for an axis whose pairs overflowed its buffer.
__global__ void __launch_bounds__(kSelectThreads)
select_pass_kernel(Geo g, const unsigned long long* keys,
                   const long long* meta, long long* sel, long long S,
                   long long max_pairs, int pass) {
  const int a = blockIdx.y;
  if (meta[kPairs + a] <= S) return;  // the gate: the buffer holds them all
  const long long cap = capacity(meta, g, a);
  const int shift = 64 - kDigitBits * (pass + 1);
  const unsigned long long prefix =
      static_cast<unsigned long long>(sel[kPrefix + a]);
  unsigned* h = reinterpret_cast<unsigned*>(sel + kSelWords) +
                static_cast<long long>(a) * kBins;
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x;
       i0 < cap; i0 += step) {
    const long long i = i0 + threadIdx.x;
    const unsigned long long key = i < cap ? keys[g.off[a] + i] : 0;
    const bool take = key != 0 &&
                      (pass == 0 || (key >> (shift + kDigitBits)) ==
                                        (prefix >> (shift + kDigitBits)));
    const unsigned digit =
        take ? static_cast<unsigned>(key >> shift) & (kBins - 1) : kBins;
    const unsigned group = __match_any_sync(0xffffffffu, digit);
    if (take && lane == __ffs(group) - 1) atomicAdd(h + digit, __popc(group));
  }
  // the last block of this axis to finish picks the digit
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(reinterpret_cast<unsigned long long*>(sel + kTicket) + a,
                     1ULL) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int kPer = kBins / kSelectThreads;
  const long long want = max_pairs - 1 - sel[kRankDone + a];  // 0-based
  long long mine = 0;
  for (int k = 0; k < kPer; ++k) mine += __ldcg(h + threadIdx.x * kPer + k);
  __shared__ long long scan[kSelectThreads];
  scan[threadIdx.x] = mine;
  __syncthreads();
  for (int s = 1; s < kSelectThreads; s <<= 1) {  // inclusive scan
    const long long v = threadIdx.x >= s ? scan[threadIdx.x - s] : 0;
    __syncthreads();
    scan[threadIdx.x] += v;
    __syncthreads();
  }
  // exactly one thread holds the wanted rank: the keys under the prefix
  // number at least want + 1 (P_a > S >= max_pairs in pass 0)
  long long below = scan[threadIdx.x] - mine;
  if (below <= want && want < scan[threadIdx.x]) {
    int d = threadIdx.x * kPer;
    for (;; ++d) {
      const long long c = __ldcg(h + d);
      if (below + c > want) break;
      below += c;
    }
    sel[kPrefix + a] = static_cast<long long>(
        prefix | static_cast<unsigned long long>(d) << shift);
    sel[kRankDone + a] += below;
  }
  if (threadIdx.x == 0) sel[kTicket + a] = 0;
  __syncthreads();  // the search above reads the bins
  for (int k = threadIdx.x; k < kBins; k += kSelectThreads) h[k] = 0;
}

// (e) The keys at or below the selected one refill axis blockIdx.y's
// buffer (entries [0, max_pairs)); the rest of it is emptied.
__global__ void __launch_bounds__(kSelectThreads)
select_keep_kernel(Geo g, const unsigned long long* keys,
                   const long long* meta, long long* sel, long long* buf_keys,
                   int* buf_slots, long long S, long long max_pairs) {
  const int a = blockIdx.y;
  if (meta[kPairs + a] <= S) return;
  const long long cap = capacity(meta, g, a);
  const unsigned long long top =
      static_cast<unsigned long long>(sel[kPrefix + a]);
  unsigned long long* kept =
      reinterpret_cast<unsigned long long*>(sel + kKept) + a;
  long long* bk = buf_keys + a * S;
  int* bs = buf_slots + a * S;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = first; i < cap; i += step) {
    const unsigned long long key = keys[g.off[a] + i];
    if (key != 0 && key <= top) {
      const unsigned long long idx = atomicAdd(kept, 1ULL);
      bk[idx] = static_cast<long long>(key);
      bs[idx] = static_cast<int>(i);
    }
  }
  for (long long i = max_pairs + first; i < S; i += step) bk[i] = kEmptyBuffer;
}

// (f) blockIdx.y: the axis. `sorted`, `order`: the (3, S) buffer's keys
// ascending and their places in the buffer.
__global__ void __launch_bounds__(kSelectThreads)
pair_slots_kernel(Geo g, const long long* __restrict__ sorted,
                  const long long* __restrict__ order,
                  const int* __restrict__ buf_slots,
                  const unsigned* __restrict__ saddles,
                  const long long* __restrict__ meta,
                  const void* __restrict__ basin, int basin_dtype,
                  long long basin_n, float ratio, long long max_pairs,
                  long long S, int* lo, int* hi, int* dropped) {
  const int a = blockIdx.y;
  const long long pairs = meta[kPairs + a];
  const long long used = pairs < max_pairs ? pairs : max_pairs;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < max_pairs; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    int out_lo = kSent, out_hi = kSent;
    if (i < used) {
      const long long key = sorted[a * S + i];
      const int slot = buf_slots[a * S + order[a * S + i]];
      const float saddle = unordered(saddles[g.off[a] + slot]);
      const int l = static_cast<int>(key >> 31);
      const int h = static_cast<int>(key & 0x7fffffff);
      long long il = l - 1LL, ih = h - 1LL;
      il = il < 0 ? 0 : (il >= basin_n ? basin_n - 1 : il);
      ih = ih < 0 ? 0 : (ih >= basin_n ? basin_n - 1 : ih);
      const float floor = fminf(load_float(basin, basin_dtype, il),
                                load_float(basin, basin_dtype, ih));
      if (saddle >= __fmul_rn(ratio, floor)) {
        out_lo = l;
        out_hi = h;
      }
    }
    lo[a * max_pairs + i] = out_lo;
    hi[a * max_pairs + i] = out_hi;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    dropped[a] = static_cast<int>(pairs > max_pairs ? pairs - max_pairs : 0);
}

Geo read_geo(const long long* v) {
  Geo g;
  for (int d = 0; d < 3; ++d) {
    g.n[d] = static_cast<int>(v[d]);
    g.ls[d] = v[3 + d];
    g.ps[d] = v[6 + d];
    g.core[d] = static_cast<int>(v[9 + d]);
    g.off[d] = v[12 + d];
    g.alloc[d] = v[15 + d];
  }
  return g;
}

int grid_for(long long n, int threads, long long most = kMaxBlocks) {
  const long long b = (n + threads - 1) / threads;
  return static_cast<int>(b < 1 ? 1 : (b < most ? b : most));
}

// the grid of (b), (d), (e): blockIdx.y the axis
dim3 sweep_grid(const Geo& g) {
  long long m = g.alloc[0];
  for (int d = 1; d < 3; ++d) m = g.alloc[d] > m ? g.alloc[d] : m;
  return dim3(grid_for(m, kSelectThreads, kSweepBlocks), 3);
}

}  // namespace

// M1. geo: 18 int64 on the host (ops/merge.py: pair_geometry); meta: 6
// zeroed int64; keys, saddles: the tables (uint64, uint32), uncleared;
// buf_keys: (3, S) int64 filled with INT64_MAX; buf_slots: (3, S) int32.
// peak_dtype: 0 float32, 1 bfloat16, 2 float16. Returns a CUDA error code
// (0 on success).
extern "C" int tpuseg_pair_aggregate(const void* labels, const void* peaks,
                                     int peak_dtype, const long long* geo,
                                     void* keys, void* saddles, void* meta,
                                     void* buf_keys, void* buf_slots,
                                     long long S, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g = read_geo(geo);
  if (g.n[0] <= 0 || g.n[1] <= 0 || g.n[2] <= 0) return cudaSuccess;
  auto* m = static_cast<long long*>(meta);
  auto* k = static_cast<unsigned long long*>(keys);
  auto* sd = static_cast<unsigned*>(saddles);
  face_count_kernel<<<row_blocks(g), kThreads, 0, s>>>(
      static_cast<const int*>(labels), g, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  table_clear_kernel<<<sweep_grid(g), kSelectThreads, 0, s>>>(g, k, sd, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pair_insert_kernel<<<row_blocks(g), kThreads, 0, s>>>(
      static_cast<const int*>(labels), peaks, peak_dtype, g, k, sd, m,
      static_cast<long long*>(buf_keys), static_cast<int*>(buf_slots), S);
  return cudaGetLastError();
}

// M2's gated select route, (d) and (e). sel: zeroed, 12 int64 then
// 3 x 65536 uint32.
extern "C" int tpuseg_pair_select(const long long* geo, const void* keys,
                                  const void* meta, void* sel,
                                  void* buf_keys, void* buf_slots,
                                  long long S, long long max_pairs,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g = read_geo(geo);
  const auto* m = static_cast<const long long*>(meta);
  auto* st = static_cast<long long*>(sel);
  const auto* k = static_cast<const unsigned long long*>(keys);
  const dim3 grid = sweep_grid(g);
  for (int pass = 0; pass < kPasses; ++pass) {
    select_pass_kernel<<<grid, kSelectThreads, 0, s>>>(g, k, m, st, S,
                                                       max_pairs, pass);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  select_keep_kernel<<<grid, kSelectThreads, 0, s>>>(
      g, k, m, st, static_cast<long long*>(buf_keys),
      static_cast<int*>(buf_slots), S, max_pairs);
  return cudaGetLastError();
}

// M2's slots, (f). basin: basin_n contiguous entries of basin_dtype (as
// peak_dtype).
extern "C" int tpuseg_pair_slots(const long long* geo, const void* sorted,
                                 const void* order, const void* buf_slots,
                                 const void* saddles, const void* meta,
                                 const void* basin, int basin_dtype,
                                 long long basin_n, float ratio,
                                 long long max_pairs, long long S, void* lo,
                                 void* hi, void* dropped, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g = read_geo(geo);
  pair_slots_kernel<<<dim3(grid_for(max_pairs, kSelectThreads), 3),
                      kSelectThreads, 0, s>>>(
      g, static_cast<const long long*>(sorted),
      static_cast<const long long*>(order),
      static_cast<const int*>(buf_slots), static_cast<const unsigned*>(saddles),
      static_cast<const long long*>(meta), basin, basin_dtype, basin_n, ratio,
      max_pairs, S, static_cast<int*>(lo), static_cast<int*>(hi),
      static_cast<int*>(dropped));
  return cudaGetLastError();
}
