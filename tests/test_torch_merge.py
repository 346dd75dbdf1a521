"""The port's saddle merge (``tpuseg_torch/ops/merge.py``) ==
``tpuseg.ops.merge`` on the same numpy labels and peak maps: the JAX
package's watershed output on synthetic stacks (analytic maps), and random
label volumes. Edges as sets per axis, the table's entries, the merged
labels elementwise, and the ``max_pairs`` cap (same pairs dropped, a
warning). The port's edges come in the reference's fixed slot layout
(``SENT`` in unused slots) with a dropped count: the sets read the used
slots, and the layout and the count are held to the reference's too."""

import re
import warnings

import jax
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
from tpuseg_torch.ops.merge import saddle_merge_axis_edges_plain

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


def _used(lo, hi):
    """The edges of the used slots, as a set of pairs."""
    return {(a, b) for a, b in zip(lo.tolist(), hi.tolist()) if a != SENT}


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
        lo, hi, _ = saddle_merge_axis_edges_plain(lab_t, pk_t, ratio, axis,
                                                  MAX_PAIRS)
        assert lo.dtype == torch.int32
        assert _used(lo, hi) == want[axis]
    e_lo, e_hi, _ = saddle_merge_edges(lab_t, pk_t, ratio, MAX_PAIRS)
    assert _used(e_lo, e_hi) == set().union(*want)
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
    got_first = np.unique(got_k.numpy(), return_index=True)[1]
    assert {int(got_k[i]): int(got_r[i]) for i in got_first
            if got_k[i] != SENT} == want
    assert [int(k) for k in got_k[got_first] if k != SENT] == sorted(want)
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
            lo, hi, _ = saddle_merge_axis_edges_plain(lab_t, pk_t, 0.0,
                                                      axis, max_pairs)
        assert len(lo) == max_pairs
        assert _used(lo, hi) == want[axis]
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
    e_lo, _, _ = saddle_merge_edges(torch.from_numpy(lab),
                                    torch.from_numpy(pk), 0.0)
    assert (e_lo == SENT).all()
    np.testing.assert_array_equal(
        saddle_merge(torch.from_numpy(lab), torch.from_numpy(pk), 0.0).numpy(),
        lab)


def _n_pairs(lab, axis):
    """Distinct adjacent label pairs across faces along ``axis`` (numpy)."""
    n = lab.shape[axis]
    a = np.take(lab, range(n - 1), axis).ravel()
    b = np.take(lab, range(1, n), axis).ravel()
    face = (a > 0) & (b > 0) & (a != b)
    pairs = np.stack([np.minimum(a, b)[face], np.maximum(a, b)[face]])
    return np.unique(pairs, axis=1).shape[1]


@pytest.mark.parametrize("ratio", [0.0, 0.8])
def test_edges_in_the_reference_slot_layout(case, ratio):
    """Slot for slot: the i-th distinct pair of each axis in slot i when it
    passes, ``SENT`` elsewhere, axis 0's slots first; each axis's dropped
    count is its distinct pairs past ``max_pairs``."""
    lab, pk = case
    want = [np.asarray(a) for a in ref_edges(
        jnp.asarray(lab), jnp.asarray(pk), ratio, max_pairs=MAX_PAIRS)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        e_lo, e_hi, dropped = saddle_merge_edges(
            torch.from_numpy(lab), torch.from_numpy(pk), ratio, MAX_PAIRS)
    np.testing.assert_array_equal(e_lo.numpy(), want[0])
    np.testing.assert_array_equal(e_hi.numpy(), want[1])
    assert dropped.dtype == torch.int32
    assert dropped.tolist() == [max(_n_pairs(lab, a) - MAX_PAIRS, 0)
                                for a in range(3)]


@pytest.mark.parametrize("max_pairs", [3, 400])
def test_dropped_count_equals_what_cond_print_reports(max_pairs, capsys):
    """The reference reports each overflowing axis's distinct pair count
    (``cond_print``); the port's dropped count is that count less
    ``max_pairs``, 0 where the reference prints nothing, and its slots
    equal the reference's."""
    lab, pk = _random_case(3)
    want = [np.asarray(a) for a in ref_edges(
        jnp.asarray(lab), jnp.asarray(pk), 0.5, max_pairs=max_pairs)]
    jax.effects_barrier()
    reported = {int(a): int(n) for n, a in re.findall(
        r"saddle merge: (\d+) distinct adjacent label pairs on axis (\d)",
        capsys.readouterr().out)}
    assert (max_pairs == 3) == (sorted(reported) == [0, 1, 2])
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        e_lo, e_hi, dropped = saddle_merge_edges(
            torch.from_numpy(lab), torch.from_numpy(pk), 0.5, max_pairs)
    assert dropped.tolist() == [reported.get(a, max_pairs) - max_pairs
                                for a in range(3)]
    assert len(log) == len(reported)
    np.testing.assert_array_equal(e_lo.numpy(), want[0])
    np.testing.assert_array_equal(e_hi.numpy(), want[1])


def test_merge_on_meta_has_fixed_shapes():
    """Every shape is fixed: the edges, the table and the merged labels
    come out on the meta device, where a host read or a data-dependent
    shape (``unique``, ``nonzero``, boolean indexing) raises."""
    lab = torch.empty((6, 10, 12), dtype=torch.int32, device="meta")
    pk = torch.empty((6, 10, 12), device="meta")
    e_lo, e_hi, dropped = saddle_merge_edges(lab, pk, 0.5, MAX_PAIRS)
    assert e_lo.shape == e_hi.shape == (3 * MAX_PAIRS,)
    assert dropped.shape == (3,)
    keys, roots = saddle_merge_table(lab, pk, 0.5, MAX_PAIRS)
    assert keys.shape == roots.shape == (6 * MAX_PAIRS,)
    assert saddle_merge(lab, pk, 0.5, MAX_PAIRS).shape == lab.shape
