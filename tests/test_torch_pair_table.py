"""A numpy model of the saddle merge's two pair-table kernels
(``tpuseg_torch/csrc/pairs.cu``: M1 ``pair_aggregate``, M2 ``pair_slots``)
held slot for slot against the plain twin (``ops/merge``'s sort of the
whole face set, which ``test_torch_merge.py`` holds to ``tpuseg.ops.merge``).

A CUDA kernel cannot run on the CPU, but what decides whether it is right
can: the geometry the wrapper hands the kernels (``pair_geometry``: extents,
strides, the grown core's region per axis, each axis's table slots), read
from the tensors' storage at their offsets and strides as the kernels read
device memory; the face count and the table's capacity; the warp's
combining of lanes that hold one key; open addressing from the mixing hash
with linear probing; the claimer's append to the S-entry buffer; the
saddles as order-keeping uint32 bits under a maximum; the gated 16-bit
radix select that refills the buffer when an axis has more than S pairs;
the buffer's sort and the passing test in float32. The model follows the
kernels step by step (their names are the kernels'). Inserts land in a
seeded random order: the outputs must not depend on it. A tiny table (one
slot more than the distinct pairs) forces long probes around the table's
end, and a small S forces the select route.

The wrapper's own contract is held here too: the meta device gives the
shapes, a CPU tensor is refused by the kernels' launchers, and the edge
functions take the twin on the CPU.

All outputs are integers, so every comparison is exact (no tolerance)."""

import functools
import warnings

import numpy as np
import pytest
import torch

from tpuseg_torch.ops.merge import (_buffer_slots, pair_aggregate,
                                    pair_geometry, pair_slots,
                                    saddle_merge_core_edges,
                                    saddle_merge_edges)

from test_torch_merge import _random_case
from test_torch_merge import _watershed_case as _watershed_uncached
from test_torch_model import single_torch_thread  # noqa: F401

SENT = 2 ** 31 - 1
EMPTY = 2 ** 63 - 1                    # kEmptyBuffer: sorts last
MAX_PAIRS = 256
MASK64 = (1 << 64) - 1
WARP = 32
BLOCK = 128                            # kThreads: x positions a block step
DIGIT_BITS = 16


def home_slot(key: int, cap: int) -> int:
    """splitmix64's finalizer; the top 32 bits scaled into [0, cap)."""
    key ^= key >> 33
    key = (key * 0xFF51AFD7ED558CCD) & MASK64
    key ^= key >> 33
    key = (key * 0xC4CEB9FE1A85EC53) & MASK64
    key ^= key >> 33
    return ((key >> 32) * cap) >> 32


def ordered(f: np.ndarray) -> np.ndarray:
    """float32 -> uint32 bits with the same order (atomicMax's operand)."""
    u = np.asarray(f, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def unordered(u: np.ndarray) -> np.ndarray:
    u = np.asarray(u, np.uint32)
    return np.where(u & 0x80000000, u & 0x7FFFFFFF, ~u).astype(
        np.uint32).view(np.float32)


def storage(t: torch.Tensor) -> np.ndarray:
    """The flat storage under ``t`` from its first element on, as float32
    for a float tensor (bf16 and fp16 convert exactly) — what the kernel
    reads from ``t.data_ptr()``."""
    size = t.untyped_storage().nbytes() // t.element_size()
    flat = t.as_strided((size - t.storage_offset(),), (1,))
    if t.dtype == torch.int32:
        return flat.numpy()
    return flat.float().numpy()


def read_geo(geo):
    """``csrc/pairs.cu``'s ``read_geo``: extents, label and peak strides,
    core, each axis's first table slot and its slot count."""
    return geo[0:3], geo[3:6], geo[6:9], geo[9:12], geo[12:15], geo[15:18]


def faces(lab, pk, geo, axis):
    """Axis ``axis``'s faces in the kernels' walk: rows (z, y), and in each
    row the x positions a block step covers (``BLOCK`` lanes, warps of
    ``WARP``). Returns the face's warp (row, x step, warp) and its key and
    value, from the storages at the geometry's strides."""
    n, ls, ps, core, _, _ = read_geo(geo)
    lim = [n[d] - 1 if d == axis else core[d] for d in range(3)]
    z, y, x = np.meshgrid(*(np.arange(max(m, 0)) for m in lim),
                          indexing="ij")
    z, y, x = z.ravel(), y.ravel(), x.ravel()
    i = z * ls[0] + y * ls[1] + x * ls[2]
    j = z * ps[0] + y * ps[1] + x * ps[2]
    a, b = lab[i], lab[i + ls[axis]]
    face = (a > 0) & (b > 0) & (a != b)
    lo = np.minimum(a, b)[face].astype(np.int64)
    hi = np.maximum(a, b)[face].astype(np.int64)
    key = lo << 31 | hi
    value = np.minimum(pk[j], pk[j + ps[axis]])[face]
    warp = np.stack([(z * n[1] + y)[face], (x // BLOCK)[face],
                     (x % BLOCK // WARP)[face]], axis=1)
    return warp, key, value


def pair_aggregate_model(lab, pk, geo, S, rng, tight=False):
    """M1: (a) the face counts and capacities, (b) the cleared tables, (c)
    the inserts — each warp's lanes of one key combined (the largest value
    of them), the warps in a random order, linear probing from the home
    slot; the claimer counts the pair and appends it to the buffer while
    fewer than S are there. ``tight``: one slot more than the distinct
    pairs instead of 2 F + 1. Returns the tables, the pair counts, the
    buffers and the longest probe."""
    alloc = read_geo(geo)[5]
    out = []
    for axis in range(3):
        warp, key, value = faces(lab, pk, geo, axis)
        distinct = len(np.unique(key))
        cap = min(2 * len(key) + 1, alloc[axis])
        if tight:
            cap = distinct + 1
        keys = np.zeros(cap, np.uint64)
        saddles = np.zeros(cap, np.uint32)
        # one insert per (warp, key): the leader carries the group's max
        inserts = {}
        for w, k, s in zip(map(tuple, warp), key.tolist(),
                           ordered(value).tolist()):
            inserts[w, k] = max(inserts.get((w, k), 0), s)
        items = list(inserts.items())
        buf_keys = np.full(S, EMPTY, np.int64)
        buf_slots = np.zeros(S, np.int64)
        pairs, longest = 0, 0
        for n_ in rng.permutation(len(items)):
            (_, k), s = items[n_]
            h = home_slot(k, cap)
            probes = 0
            while keys[h] != 0 and keys[h] != k:
                h = (h + 1) % cap
                probes += 1
            longest = max(longest, probes)
            if keys[h] == 0:
                keys[h] = k
                if pairs < S:
                    buf_keys[pairs], buf_slots[pairs] = k, h
                pairs += 1
            saddles[h] = max(saddles[h], s)
        assert pairs == distinct
        out.append(dict(keys=keys, saddles=saddles, pairs=pairs,
                        buf_keys=buf_keys, buf_slots=buf_slots,
                        longest=longest))
    return out


def radix_select(keys: np.ndarray, rank: int) -> int:
    """(d): the ``rank``-th smallest (0-based) non-zero key, 16 bits a pass
    from the top: a histogram of the digit among the keys that share the
    prefix so far, then the digit whose bins hold the rank."""
    keys = [int(k) for k in keys if k != 0]
    prefix, done = 0, 0
    for p in range(64 // DIGIT_BITS):
        shift = 64 - DIGIT_BITS * (p + 1)
        hist = np.zeros(1 << DIGIT_BITS, np.int64)
        for k in keys:
            if p == 0 or k >> (shift + DIGIT_BITS) == \
                    prefix >> (shift + DIGIT_BITS):
                hist[k >> shift & 0xFFFF] += 1
        below = np.cumsum(hist) - hist
        d = int(np.nonzero((below <= rank - done)
                           & (rank - done < below + hist))[0][0])
        prefix |= d << shift
        done += int(below[d])
    return prefix


def pair_slots_model(tables, basin, ratio, max_pairs, S):
    """M2: the gated select route (an axis with more pairs than S refills
    its buffer with the keys at or below its ``max_pairs``-th smallest),
    the buffer's sort, and (f) the slots and the dropped counts."""
    lo = np.full(3 * max_pairs, SENT, np.int32)
    hi = lo.copy()
    dropped = np.zeros(3, np.int32)
    for axis, t in enumerate(tables):
        buf_keys, buf_slots = t["buf_keys"].copy(), t["buf_slots"].copy()
        if t["pairs"] > S:
            top = radix_select(t["keys"], max_pairs - 1)
            kept = [(int(k), h) for h, k in enumerate(t["keys"])
                    if k != 0 and k <= top]
            assert len(kept) == max_pairs
            buf_keys[:] = EMPTY
            buf_slots[:] = 0
            for n_, (k, h) in enumerate(kept):
                buf_keys[n_], buf_slots[n_] = k, h
        order = np.argsort(buf_keys, kind="stable")
        used = min(t["pairs"], max_pairs)
        for i in range(used):
            key = int(buf_keys[order[i]])
            saddle = unordered(t["saddles"][buf_slots[order[i]]])
            l_, h_ = key >> 31, key & SENT
            il = min(max(l_ - 1, 0), basin.size - 1)
            ih = min(max(h_ - 1, 0), basin.size - 1)
            floor = np.minimum(basin[il], basin[ih])
            if saddle >= np.float32(ratio) * np.float32(floor):
                lo[axis * max_pairs + i] = l_
                hi[axis * max_pairs + i] = h_
        dropped[axis] = max(t["pairs"] - max_pairs, 0)
    return lo, hi, dropped


def model_edges(labels, peak_prob, core, ratio, max_pairs, basin=None,
                S=None, tight=False, seed=0):
    """M1 + M2 as the wrapper runs them, on CPU tensors (any strides)."""
    geo = pair_geometry(labels, peak_prob, core)
    S = _buffer_slots(max_pairs) if S is None else S
    tables = pair_aggregate_model(storage(labels), storage(peak_prob), geo,
                                  S, np.random.default_rng(seed), tight)
    if basin is None:
        basin = peak_prob.contiguous()
    basin = storage(basin)[:basin.numel()]
    return pair_slots_model(tables, basin, ratio, max_pairs, S), tables


def twin_edges(labels, peak_prob, core, ratio, max_pairs, basin=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if basin is None:
            return saddle_merge_edges(labels, peak_prob, ratio, max_pairs)
        return saddle_merge_core_edges(labels, peak_prob, core, ratio, basin,
                                       max_pairs)


@functools.cache
def _watershed_case(seed):
    return _watershed_uncached(seed)


def assert_same(got, want):
    for g, w, name in zip(got, want, ("lo", "hi", "dropped")):
        np.testing.assert_array_equal(np.asarray(g), w.numpy(), err_msg=name)


CASES = [("watershed", 0), ("watershed", 1), ("random", 0), ("random", 1)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}{c[1]}")
def case(request):
    kind, seed = request.param
    lab, pk = (_watershed_case if kind == "watershed" else _random_case)(seed)
    return torch.from_numpy(lab), torch.from_numpy(pk)


@pytest.mark.parametrize("ratio", [0.0, 0.5, 0.8])
@pytest.mark.parametrize("table", ["2F+1", "tight"])
def test_model_equals_twin(case, ratio, table):
    """M1 + M2 == the twin, slot for slot, with the kernels' table and
    with the tightest table that cannot fail (long probes)."""
    lab, pk = case
    got, tables = model_edges(lab, pk, lab.shape, ratio, MAX_PAIRS,
                              tight=table == "tight", seed=int(ratio * 10))
    assert_same(got, twin_edges(lab, pk, lab.shape, ratio, MAX_PAIRS))
    if table == "tight":
        assert max(t["longest"] for t in tables) >= 2


@pytest.mark.parametrize("S", [2, 3])
def test_select_route_equals_twin(case, S):
    """An S below every axis's distinct pairs (down to S = max_pairs, no
    empty entry left) takes the gated radix select; the slots still equal
    the twin's."""
    lab, pk = case
    got, tables = model_edges(lab, pk, lab.shape, 0.5, 2, S=S)
    assert all(t["pairs"] > S for t in tables)
    assert_same(got, twin_edges(lab, pk, lab.shape, 0.5, 2))


@pytest.mark.parametrize("max_pairs", [3, 7])
@pytest.mark.parametrize("table", ["2F+1", "tight"])
def test_cap_cases_drop_the_same_pairs(max_pairs, table):
    """The ``max_pairs`` cap cases of ``test_torch_merge.py``: the same
    pairs kept, the same dropped counts; S = 2 max_pairs is below every
    axis's distinct pairs there, so each axis selects."""
    lab, pk = (torch.from_numpy(a) for a in _random_case(2))
    (lo, hi, dropped), tables = model_edges(
        lab, pk, lab.shape, 0.0, max_pairs, tight=table == "tight")
    assert all(t["pairs"] > _buffer_slots(max_pairs) for t in tables)
    assert_same((lo, hi, dropped),
                twin_edges(lab, pk, lab.shape, 0.0, max_pairs))
    assert (dropped > 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_peak_dtypes(dtype):
    """Peaks are read in their own dtype; each converts exactly, so the
    slots equal the twin's (which converts the map to float32)."""
    lab, pk = _watershed_case(0)
    lab, pk = torch.from_numpy(lab), torch.from_numpy(pk).to(dtype)
    got, _ = model_edges(lab, pk, lab.shape, 0.8, MAX_PAIRS)
    assert_same(got, twin_edges(lab, pk, lab.shape, 0.8, MAX_PAIRS))


def _grown_core(seed, cut):
    """A shard's grown core as the sharded paths hand it over: a view of
    the slab (not contiguous), one plane past the core along each cut dim,
    with the whole stack's flat peaks as the basins' maxima."""
    lab, pk = (torch.from_numpy(a) for a in _watershed_case(seed))
    core = [s // 2 if d in cut else s for d, s in enumerate(lab.shape)]
    start = [3 if d in cut else 0 for d in range(3)]
    grown = [c + 1 if d in cut else c for d, c in enumerate(core)]
    view = tuple(slice(s, s + g) for s, g in zip(start, grown))
    return lab[view], pk[view], tuple(core), pk.reshape(-1).clone()


@pytest.mark.parametrize("cut", [(0,), (1,), (0, 1), (1, 2)])
@pytest.mark.parametrize("ratio", [0.0, 0.8])
def test_grown_core_equals_twin(cut, ratio):
    """``saddle_merge_core_edges`` on a non-contiguous grown core: the
    kernels read it in place at its strides, and each axis's region is the
    core grown along that axis only."""
    lab, pk, core, basin = _grown_core(1, cut)
    assert lab.is_contiguous() == pk.is_contiguous() == (cut == (0,))
    geo = pair_geometry(lab, pk, core)
    assert geo[3:6] == list(lab.stride()) and geo[9:12] == list(core)
    for axis in range(3):
        region = [lab.shape[d] - 1 if d == axis else core[d]
                  for d in range(3)]
        assert geo[15 + axis] == np.prod(region) + 1
    got, _ = model_edges(lab, pk, core, ratio, MAX_PAIRS, basin=basin)
    assert_same(got, twin_edges(lab, pk, core, ratio, MAX_PAIRS, basin))
    got, _ = model_edges(lab, pk, core, ratio, 5, basin=basin, tight=True)
    assert_same(got, twin_edges(lab, pk, core, ratio, 5, basin))


def test_insert_order_and_bits():
    """The order-keeping bits invert and keep the order (signed zeros and
    infinities included), and a shuffled insert order gives the same
    slots."""
    f = np.array([-np.inf, -2.5, -0.0, 0.0, 1e-30, 0.25, 1.0, np.inf],
                 np.float32)
    u = ordered(f)
    assert (np.diff(u.astype(np.int64)) > 0).all()
    np.testing.assert_array_equal(unordered(u).view(np.uint32),
                                  f.view(np.uint32))
    lab, pk = (torch.from_numpy(a) for a in _watershed_case(0))
    runs = [model_edges(lab, pk, lab.shape, 0.5, 16, seed=s)[0]
            for s in range(3)]
    for r in runs[1:]:
        for a, b in zip(r, runs[0]):
            np.testing.assert_array_equal(a, b)


def test_meta_device_gives_the_shapes():
    """On the meta device M1 and M2 return their shapes without a launch;
    the table holds each axis's face positions + 1 slots."""
    shape, max_pairs = (6, 10, 12), 64
    lab = torch.empty(shape, dtype=torch.int32, device="meta")
    pk = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    before = (pair_aggregate.launches, pair_slots.launches)
    table = pair_aggregate(lab, pk, None, max_pairs)
    positions = [5 * 10 * 12, 6 * 9 * 12, 6 * 10 * 11]
    assert table.keys.shape == table.saddles.shape == (
        sum(positions) + 3,)
    assert table.buf_keys.shape == (3, 2 * max_pairs)
    lo, hi, dropped = pair_slots(table, pk, 0.5, max_pairs)
    assert lo.shape == hi.shape == (3 * max_pairs,)
    assert lo.dtype == hi.dtype == dropped.dtype == torch.int32
    assert dropped.shape == (3,)
    assert (pair_aggregate.launches, pair_slots.launches) == before
    big = torch.empty((8, 12, 12), dtype=torch.int32, device="meta")
    e_lo, _, d = saddle_merge_core_edges(
        big[1:, 1:], torch.empty((8, 12, 12), device="meta")[1:, 1:],
        (6, 10, 11), 0.5, torch.empty(1152, device="meta"), max_pairs)
    assert e_lo.shape == (3 * max_pairs,) and d.shape == (3,)


def test_launchers_refuse_what_they_cannot_take():
    """The kernels' launchers take CUDA (or meta) tensors only: a CPU
    tensor, another label dtype or a core past the volume raises. The edge
    functions take the twin on the CPU instead."""
    lab, pk = (torch.from_numpy(a) for a in _random_case(0))
    with pytest.raises(ValueError, match="CUDA"):
        pair_aggregate(lab, pk)
    meta = lab.to("meta")
    with pytest.raises(ValueError):
        pair_aggregate(meta.to(torch.int64), pk.to("meta"))
    with pytest.raises(ValueError):
        pair_aggregate(meta, pk.to("meta"), core=(7, 10, 12))
    table = pair_aggregate(meta, pk.to("meta"), max_pairs=8)
    with pytest.raises(ValueError, match="max_pairs"):
        pair_slots(table, pk.to("meta"), 0.5, max_pairs=16)
    with pytest.raises(ValueError, match="float32"):
        saddle_merge_core_edges(meta, pk.to("meta"), meta.shape, 0.5,
                                torch.empty(9, dtype=torch.float64,
                                            device="meta"))
    n = pair_aggregate.launches
    e = saddle_merge_edges(lab, pk, 0.5, MAX_PAIRS)
    assert e[0].device.type == "cpu" and pair_aggregate.launches == n
