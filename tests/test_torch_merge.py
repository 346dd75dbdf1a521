"""The port's saddle merge (``tpuseg_torch/ops/merge.py``) ==
``tpuseg.ops.merge`` on the same numpy labels and peak maps: the JAX
package's watershed output on synthetic stacks (analytic maps), and random
label volumes. Edges as sets per axis, the table's entries, the merged
labels elementwise, and the ``max_pairs`` cap (same pairs dropped, a
warning)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.data import synthesize_volume
from tpuseg.ops import watershed as ref_watershed
from tpuseg.ops.merge import apply_merge_table as ref_apply
from tpuseg.ops.merge import saddle_merge as ref_saddle_merge
from tpuseg.ops.merge import saddle_merge_edges as ref_edges
from tpuseg.ops.merge import saddle_merge_table as ref_table
from tpuseg_torch.ops import (apply_merge_table, saddle_merge,
                              saddle_merge_edges, saddle_merge_table)
from tpuseg_torch.ops.merge import saddle_merge_axis_edges

from test_torch_model import single_torch_thread  # noqa: F401

SENT = 2 ** 31 - 1
MAX_PAIRS = 256


def _sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


def _watershed_case(seed):
    """Touching nuclei: the reference watershed's labels on analytic maps."""
    sv = synthesize_volume(shape=(24, 48, 48), num_instances=40,
                           radius_range=(3.0, 6.0), min_center_dist=6.0,
                           seed=seed)
    fg = _sigmoid((sv.image - 0.35) * 25.0)
    pk = _sigmoid((sv.image - 0.75) * 25.0)
    lab = np.asarray(ref_watershed(jnp.asarray(fg), jnp.asarray(pk),
                                   peak_threshold=0.5, fg_threshold=0.5,
                                   peak_radius=1))
    return lab.copy(), pk


def _random_case(seed):
    """Random labels in 1..n (root index + 1) over a random peak map."""
    rng = np.random.default_rng(seed)
    shape = (6, 10, 12)
    n = int(np.prod(shape))
    pool = rng.choice(np.arange(1, n + 1), size=30, replace=False)
    lab = np.where(rng.random(shape) < 0.2, 0,
                   rng.choice(pool, size=shape)).astype(np.int32)
    return lab, rng.random(shape, dtype=np.float32)


CASES = [("watershed", 0), ("watershed", 1), ("random", 0), ("random", 1)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}{c[1]}")
def case(request):
    kind, seed = request.param
    return (_watershed_case if kind == "watershed" else _random_case)(seed)


def _ref_axis_sets(lab, pk, ratio, max_pairs):
    el, eh = (np.asarray(a) for a in ref_edges(
        jnp.asarray(lab), jnp.asarray(pk), ratio, max_pairs=max_pairs))
    return [{(int(a), int(b))
             for a, b in zip(el[x * max_pairs:(x + 1) * max_pairs],
                             eh[x * max_pairs:(x + 1) * max_pairs])
             if a != SENT} for x in range(3)]


@pytest.mark.parametrize("ratio", [0.0, 0.5, 0.8])
def test_edges_per_axis_equal_reference(case, ratio):
    lab, pk = case
    want = _ref_axis_sets(lab, pk, ratio, MAX_PAIRS)
    lab_t, pk_t = torch.from_numpy(lab), torch.from_numpy(pk)
    for axis in range(3):
        lo, hi = saddle_merge_axis_edges(lab_t, pk_t, ratio, axis, MAX_PAIRS)
        assert lo.dtype == torch.int32
        assert set(zip(lo.tolist(), hi.tolist())) == want[axis]
    e_lo, e_hi = saddle_merge_edges(lab_t, pk_t, ratio, MAX_PAIRS)
    assert set(zip(e_lo.tolist(), e_hi.tolist())) == set().union(*want)
    if ratio == 0.0:
        assert sum(map(len, want)) > 0


@pytest.mark.parametrize("ratio", [0.5, 0.8])
def test_table_and_merged_labels_equal_reference(case, ratio):
    lab, pk = case
    keys, roots = (np.asarray(a) for a in ref_table(
        jnp.asarray(lab), jnp.asarray(pk), ratio, max_pairs=MAX_PAIRS))
    # the reference's sorted table repeats a key once per edge end; its
    # lookups (searchsorted, left) read the first copy
    first = np.unique(keys, return_index=True)[1]
    want = {int(keys[i]): int(roots[i]) for i in first if keys[i] != SENT}
    got_k, got_r = saddle_merge_table(torch.from_numpy(lab),
                                      torch.from_numpy(pk), ratio, MAX_PAIRS)
    assert dict(zip(got_k.tolist(), got_r.tolist())) == want
    assert got_k.tolist() == sorted(want)
    got = saddle_merge(torch.from_numpy(lab), torch.from_numpy(pk), ratio,
                       MAX_PAIRS)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_saddle_merge(
            jnp.asarray(lab), jnp.asarray(pk), ratio, max_pairs=MAX_PAIRS)))


def test_merge_changes_the_watershed_labels():
    """The cases above do merge: at ratio 0.5 some basins join."""
    lab, pk = _watershed_case(0)
    got = saddle_merge(torch.from_numpy(lab), torch.from_numpy(pk), 0.5,
                       MAX_PAIRS).numpy()
    assert len(np.unique(got)) < len(np.unique(lab))


@pytest.mark.parametrize("max_pairs", [3, 7])
def test_cap_drops_the_same_pairs_and_warns(max_pairs):
    lab, pk = _random_case(2)
    want = _ref_axis_sets(lab, pk, 0.0, max_pairs)
    lab_t, pk_t = torch.from_numpy(lab), torch.from_numpy(pk)
    for axis in range(3):
        with pytest.warns(UserWarning, match=f"on axis {axis} exceed "
                                             f"max_pairs={max_pairs}"):
            lo, hi = saddle_merge_axis_edges(lab_t, pk_t, 0.0, axis,
                                             max_pairs)
        assert len(lo) == max_pairs
        assert set(zip(lo.tolist(), hi.tolist())) == want[axis]
    np.testing.assert_array_equal(
        saddle_merge(lab_t, pk_t, 0.5, max_pairs).numpy(),
        np.asarray(ref_saddle_merge(jnp.asarray(lab), jnp.asarray(pk), 0.5,
                                    max_pairs=max_pairs)))


def test_apply_table_passthrough():
    lab = torch.tensor([[[0, 5, 7, 9]]], dtype=torch.int32)
    keys = torch.tensor([5, 7], dtype=torch.int32)
    roots = torch.tensor([5, 5], dtype=torch.int32)
    got = apply_merge_table(lab, keys, roots)
    want = np.asarray(ref_apply(
        jnp.asarray(lab.numpy()), jnp.asarray([5, 7] + [SENT] * 6, jnp.int32),
        jnp.asarray([5, 5] + [SENT] * 6, jnp.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [[[0, 5, 5, 9]]]
    empty = torch.zeros(0, dtype=torch.int32)
    assert torch.equal(apply_merge_table(lab, empty, empty), lab)


def test_no_contact_no_edges():
    lab = np.zeros((4, 4, 16), np.int32)
    lab[1:3, 1:3, 1:4] = 22
    lab[1:3, 1:3, 10:13] = 27
    pk = np.ones(lab.shape, np.float32)
    e_lo, _ = saddle_merge_edges(torch.from_numpy(lab), torch.from_numpy(pk),
                                 0.0)
    assert e_lo.numel() == 0
    np.testing.assert_array_equal(
        saddle_merge(torch.from_numpy(lab), torch.from_numpy(pk), 0.0).numpy(),
        lab)
