"""The port's union-find closure (U1, ``tpuseg_torch/ops/closure.py``; on
the CPU its plain twin) == the JAX package's closures on the same numpy
edges: ``tpuseg.parallel.reconcile._closure_table`` (the sharded paths'),
the closure inside ``tpuseg.ops.merge.saddle_merge_table`` (the saddle
merge's, fed a row of labels whose neighbours are the edges) and the port's
numpy ``ops/components.union_closure`` (the streamed path's). Cases:
random graphs, duplicate, self and inactive rows, a star, an all-inactive
table and a long path in adversarial (bit-reversed) order, where the
rounds the reference's fixed-round loop needs are recorded beside the
rounds it runs. U1 closes to the fixed point; the reference stops after
``ceil(log2 m) + 1`` rounds. On the meta device the wrapper gives the
table's shapes with no host read."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.ops.merge import saddle_merge_table as ref_merge_table
from tpuseg.parallel.reconcile import _closure_table as ref_closure_table
from tpuseg_torch.ops import union_closure, union_closure_plain
from tpuseg_torch.ops.closure import SENTINELS
from tpuseg_torch.ops.components import rename
from tpuseg_torch.ops.components import union_closure as np_union_closure

from test_torch_model import single_torch_thread  # noqa: F401

SENT = 2 ** 31 - 1


def _bitrev_path(bits: int) -> np.ndarray:
    """The values 1..2^bits in bit-reversed order: a path whose neighbours'
    values are far apart at every scale."""
    idx = np.arange(1 << bits)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev + 1


def _path_edges(order: np.ndarray, seed: int) -> np.ndarray:
    e = np.stack([order[:-1], order[1:]], axis=1).astype(np.int32)
    return e[np.random.default_rng(seed).permutation(len(e))]


def _random_edges(seed: int, n_edges: int, n_values: int) -> np.ndarray:
    """Random edges over 0..n_values, so some rows hold a 0 (inactive),
    with self edges and repeated rows."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n_values + 1, (n_edges, 2)).astype(np.int32)
    e[::7, 1] = e[::7, 0]                            # self edges
    return np.concatenate([e, e[: n_edges // 5]])    # repeated rows


def _star(n: int) -> np.ndarray:
    leaves = np.arange(2, n + 2, dtype=np.int32)
    return np.stack([leaves, np.full_like(leaves, 1)], axis=1)[::-1].copy()


CASES = {
    "random_small": lambda: _random_edges(0, 40, 30),
    "random_dense": lambda: _random_edges(1, 600, 200),
    "random_sparse": lambda: _random_edges(2, 300, 5000),
    "star": lambda: _star(500),
    "all_inactive": lambda: np.zeros((64, 2), np.int32),
    "path_bitrev": lambda: _path_edges(_bitrev_path(12), 3),
}


def _port(edges: np.ndarray):
    e = torch.from_numpy(edges)
    return (t.numpy() for t in union_closure(e[:, 0].contiguous(),
                                             e[:, 1].contiguous()))


def _lookup(keys, reps, vals):
    """``vals`` through a sorted ``(keys, reps)`` table, as the callers
    read it (``searchsorted``, left: a repeated key's first copy)."""
    pos = np.clip(np.searchsorted(keys, vals), 0, len(keys) - 1)
    return np.where(keys[pos] == vals, reps[pos], vals)


@pytest.mark.parametrize("name", sorted(CASES))
def test_closure_equals_reconcile_closure(name):
    """Keys bitwise the reference's (the same sorted slots), the groups'
    smallest values equal at every key's first copy, and every copy of a
    key holds its group's smallest value."""
    edges = CASES[name]()
    keys, reps = _port(edges)
    rk, rr = (np.asarray(a) for a in jax.jit(ref_closure_table)(
        jnp.asarray(edges)))
    np.testing.assert_array_equal(keys, rk)
    vals = np.unique(edges)
    np.testing.assert_array_equal(_lookup(keys, reps, vals),
                                  _lookup(rk, rr, vals))
    np.testing.assert_array_equal(reps, _lookup(keys, reps, keys))
    assert (reps[keys == SENT] == SENT).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_closure_equals_numpy_union_closure(name):
    edges = CASES[name]()
    keys, reps = _port(edges)
    active = edges[(edges > 0).all(axis=1)].astype(np.int64)
    nk, nr = np_union_closure(active)
    vals = np.unique(edges)
    np.testing.assert_array_equal(_lookup(keys, reps, vals),
                                  rename(vals.astype(np.int64), nk, nr))


@pytest.mark.parametrize("name", ["random_dense", "path_bitrev", "star"])
def test_closure_equals_merge_table_closure(name):
    """The saddle merge's closure: a row of labels, each neighbour pair an
    edge (a path of the labels in row order), every pair passing; the
    reference's table against U1's over the same passing edges."""
    order = (CASES[name]().reshape(-1) if name != "path_bitrev"
             else _bitrev_path(12))
    lab = order.astype(np.int32).reshape(1, 1, -1)
    pk = np.ones(lab.shape, np.float32)
    n_pairs = lab.size
    rk, rr = (np.asarray(a) for a in ref_merge_table(
        jnp.asarray(lab), jnp.asarray(pk), 0.5, max_pairs=n_pairs))
    u = torch.from_numpy(np.minimum(lab[0, 0, :-1], lab[0, 0, 1:]))
    v = torch.from_numpy(np.maximum(lab[0, 0, :-1], lab[0, 0, 1:]))
    keep = u != v
    keys, reps = (t.numpy() for t in union_closure(u[keep].contiguous(),
                                                   v[keep].contiguous()))
    vals = np.unique(lab)
    np.testing.assert_array_equal(_lookup(keys, reps, vals),
                                  _lookup(rk, rr, vals))


def _rounds_needed(edges: np.ndarray) -> int:
    """Rounds of the reference's loop (scatter-min hook, two pointer
    jumps: ``tpuseg/parallel/reconcile.py:64-71``) until one group is
    left, in numpy."""
    keys = np.unique(edges)
    a, b = np.searchsorted(keys, edges[:, 0]), np.searchsorted(keys,
                                                              edges[:, 1])
    parent = np.arange(len(keys))
    rounds = 0
    while len(np.unique(parent)) > 1:
        ra, rb = parent[a], parent[b]
        np.minimum.at(parent, np.maximum(ra, rb), np.minimum(ra, rb))
        parent = parent[parent[parent]]
        rounds += 1
    return rounds


@pytest.mark.parametrize("bits", [8, 12])
def test_long_path_rounds_of_the_reference(bits):
    """The bit-reversed path, the deepest order found for this loop: it
    needs ``bits`` rounds, and the reference runs ceil(log2 2E) + 1, so
    the reference reaches the fixed point here and its labels equal U1's
    (which closes to the fixed point in any order)."""
    edges = _path_edges(_bitrev_path(bits), bits)
    needed = _rounds_needed(edges)
    runs = max(2, math.ceil(math.log2(2 * len(edges))) + 1)
    assert needed == bits < runs
    keys, reps = _port(edges)
    assert (reps[keys != SENT] == 1).all()
    rk, rr = (np.asarray(a) for a in jax.jit(ref_closure_table)(
        jnp.asarray(edges)))
    assert (_lookup(rk, rr, np.unique(edges)) == 1).all()


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_dtypes_and_sentinel_rows(dtype):
    """int64 endpoints take the int64 sentinel; a row with a sentinel or a
    0 is inactive."""
    sent = SENTINELS[dtype]
    u = torch.tensor([5, 9, sent, 0, 40, 7], dtype=dtype)
    v = torch.tensor([9, 120, 3, 3, 2, 7], dtype=dtype)
    keys, reps = union_closure(u, v)
    assert keys.dtype == reps.dtype == dtype and keys.numel() == 12
    got = dict(zip(keys.tolist(), reps.tolist()))
    assert got[5] == got[9] == got[120] == 5
    assert got[40] == got[2] == 2 and got[7] == 7
    assert 3 not in got and got[sent] == sent
    pk, pr = union_closure_plain(u, v)
    assert torch.equal(pk, keys) and torch.equal(pr, reps)


def test_meta_shapes_without_host_read():
    """On the meta device (no values: a host read or a data-dependent
    shape raises) the wrapper builds the table and gives its shapes."""
    u = torch.empty(37, dtype=torch.int32, device="meta")
    keys, reps = union_closure(u, torch.empty_like(u))
    assert keys.shape == reps.shape == (74,) and reps.device.type == "meta"


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="endpoint tensors of one length"):
        union_closure(torch.zeros(3, dtype=torch.int32),
                      torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="endpoint tensors"):
        union_closure(torch.zeros(3), torch.zeros(3))
