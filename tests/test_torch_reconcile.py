"""The port's cross-shard reconciliation (``tpuseg_torch/parallel/
reconcile.py``) == ``tpuseg.parallel.reconcile`` on the same per-shard
inputs: the JAX functions run inside ``shard_map`` on the virtual CPU
devices of ``tests/conftest.py``, the port's on lists of CPU tensors.

The JAX package names table entries by an int32 (z plane, in-plane) pair;
the port by one int64 coordinate ``hi * PLANE + lo``, which orders the
same. Random cases hold cap overflow (more distinct ids than the table
takes), the global size filter and the closure over cross-shard edges.
Tables and edge lists have the reference's fixed sizes (unused table slots
hold 2^31 - 1, inactive edge rows 0) and the distinct counts are 0-d
tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from tpuseg.parallel import reconcile as ref
from tpuseg_torch.parallel import reconcile
from tpuseg_torch.parallel.collectives import ppermute

from test_torch_model import single_torch_thread  # noqa: F401

PLANE = 64                      # in-plane voxels of the coordinate pair


def _smap(fn, n, *args, out_specs=P("z")):
    """``fn`` over ``n`` shards (leading axis of each arg) on the JAX
    package's side."""
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("z",))
    return np.asarray(jax.jit(shard_map(
        fn, mesh=mesh, in_specs=tuple(P("z") for _ in args),
        out_specs=out_specs, check_rep=False))(*[jnp.asarray(a)
                                                for a in args]))


def test_overflow_does_not_inflate_last_entry_count(capsys):
    """``tests/distributed/test_reconcile_overflow.py``: shard 0 has four
    ids (> cap 2); the table keeps {1, 2} with id 2's true size 1, which
    the global ``min_size=3`` drops; ids 3, 4 overflow to 0."""
    cap = 2
    shard0 = np.array([1] * 6 + [2] * 1 + [3] * 5 + [4] * 4, np.int32)
    shard1 = np.zeros(16, np.int32)
    labels = np.stack([shard0, shard1])
    want = _smap(lambda l: ref.global_compact_labels(l, "z", cap, min_size=3),
                 2, labels)
    got = reconcile.global_compact_labels(
        [torch.from_numpy(s) for s in labels], cap, min_size=3)
    expected0 = np.array([1] * 6 + [0] * 10, np.int32)
    np.testing.assert_array_equal(got[0].numpy(), expected0)
    np.testing.assert_array_equal(got[1].numpy(), np.zeros(16, np.int32))
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)
    assert "global_compact_labels OVERFLOW — a shard has 4 distinct labels " \
        "> cap 2" in capsys.readouterr().out


@pytest.mark.parametrize("seed,cap,min_size", [(0, 6, 0), (1, 6, 4),
                                               (2, 40, 3)])
def test_global_compact_labels_equal_reference(seed, cap, min_size):
    rng = np.random.default_rng(seed)
    labels = np.where(rng.random((4, 5, 6)) < 0.4, 0,
                      rng.integers(1, 30, (4, 5, 6))).astype(np.int32)
    want = _smap(lambda l: ref.global_compact_labels(
        l[0], "z", cap, min_size=min_size)[None], 4, labels)
    got = reconcile.global_compact_labels(
        [torch.from_numpy(s) for s in labels], cap, min_size=min_size)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)


def _random_shard(rng, n_ids, shape=(3, 4, 5)):
    """Labels drawn from ``n_ids`` ids, about a third background."""
    return np.where(rng.random(shape) < 0.35, 0,
                    rng.integers(1, n_ids + 1, shape)).astype(np.int32)


@pytest.mark.parametrize("seed,cap,n_ids", [(0, 64, 12), (1, 5, 30),
                                            (2, 9, 60), (3, 1, 4)])
def test_build_local_table_equals_reference(seed, cap, n_ids):
    """The table (the ``cap`` smallest distinct ids of the core and the
    planes) and its core counts (true run lengths) equal the reference's;
    the port's ``n_distinct`` is the true distinct count, which the
    reference's (taken over the candidates truncated to ``cap``) never
    exceeds and which reports every overflow the reference's does."""
    rng = np.random.default_rng(seed)
    core = _random_shard(rng, n_ids)
    planes = [_random_shard(rng, n_ids + 10, (4, 5)) for _ in range(2)]
    t_ref, c_ref, n_ref = jax.jit(ref.build_local_table, static_argnums=2)(
        jnp.asarray(core), [jnp.asarray(p) for p in planes], cap)
    t_ref, c_ref = np.asarray(t_ref), np.asarray(c_ref)
    used = t_ref < ref._SENTINEL
    table, counts, n = reconcile.build_local_table(
        torch.from_numpy(core), [torch.from_numpy(p) for p in planes], cap)
    np.testing.assert_array_equal(table.numpy(), t_ref)
    np.testing.assert_array_equal(counts.numpy(), c_ref)
    assert (table.numpy() < ref._SENTINEL).sum() == used.sum()
    truth = np.unique(np.concatenate([core.ravel()] + [p.ravel()
                                                      for p in planes]))
    assert n.dim() == 0
    n = int(n)
    assert n == int((truth > 0).sum()) >= int(n_ref)
    assert (n > cap) >= (int(n_ref) > cap)
    packed = reconcile.rename_to_packed(torch.from_numpy(core), table, 3, cap)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(ref.rename_to_packed(
            jnp.asarray(core), jnp.asarray(t_ref), 3, cap)))


def _packed_case(seed, n_shards, cap, n_ids):
    """Per-shard inputs of ``packed_compact_labels``: each shard's random
    labels (ids unique to the shard, so no two groups share a root), its
    table with cap overflow, each entry's root coordinate (its id - 1) as
    the reference's (hi, lo) pair and the port's int64 key, and the edges
    between a shard's first plane and its lower neighbour's last."""
    rng = np.random.default_rng(seed)
    cores, tables, counts, packed = [], [], [], []
    for r in range(n_shards):
        local = _random_shard(rng, n_ids, (3, 4, 6))
        core = np.where(local > 0, local + 1000 * r, 0).astype(np.int32)
        t, c, _ = reconcile.build_local_table(torch.from_numpy(core), [], cap)
        cores.append(core)
        tables.append(t)
        counts.append(c)
        packed.append(reconcile.rename_to_packed(torch.from_numpy(core), t,
                                                 r, cap))
    theirs = ppermute([p[-1] for p in packed],
                      [(j, j + 1) for j in range(n_shards - 1)])
    edges = [reconcile.boundary_edges(packed[r][0], theirs[r])
             for r in range(n_shards)]
    keys = [torch.where(t < ref._SENTINEL, t.to(torch.int64) - 1,
                        reconcile._SENTINEL) for t in tables]
    return packed, keys, counts, edges


def _ref_coords(keys, cap):
    """The reference's (hi, lo) pairs of the port's coordinates, the
    reference's sentinel on unused slots."""
    sent = ref._SENTINEL
    k = [key.numpy() for key in keys]
    return (np.stack([_pad(np.where(x < reconcile._SENTINEL, x // PLANE,
                                    sent), cap, sent) for x in k]),
            np.stack([_pad(np.where(x < reconcile._SENTINEL, x % PLANE,
                                    sent), cap, sent) for x in k]))


def _pad(a, n, fill):
    a = np.asarray(a)
    return np.concatenate([a, np.full((n - len(a),) + a.shape[1:], fill,
                                      a.dtype)])


@pytest.mark.parametrize("seed,n_shards,cap,n_ids,min_size", [
    (0, 4, 64, 20, 0), (1, 4, 8, 20, 3), (2, 2, 5, 12, 2), (3, 8, 16, 9, 4)])
def test_packed_compact_labels_equal_reference(seed, n_shards, cap, n_ids,
                                               min_size):
    packed, keys, counts, edges = _packed_case(seed, n_shards, cap, n_ids)
    got = reconcile.packed_compact_labels(packed, keys, counts, edges, cap,
                                          n_shards, min_size=min_size)
    hi, lo = _ref_coords(keys, cap)
    cnt = np.stack([_pad(c.numpy(), cap, 0) for c in counts])
    n_e = max(max(len(e) for e in edges), 1)
    e = np.stack([_pad(e.numpy().reshape(-1, 2), n_e, 0) for e in edges])

    def body(core, h, l, c, ed):
        return ref.packed_compact_labels(
            core[0], h[0].astype(jnp.int32), l[0].astype(jnp.int32),
            c[0].astype(jnp.int32), ed[0].astype(jnp.int32), "z", cap,
            n_shards, min_size=min_size)[None]

    want = _smap(body, n_shards, np.stack([p.numpy() for p in packed]),
                 hi, lo, cnt, e)
    got = np.stack([g.numpy() for g in got])
    assert got.max() >= 3
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,n_shards,cap,n_ids", [(0, 4, 64, 20),
                                                     (1, 2, 7, 15)])
def test_packed_merge_to_coord_labels_equal_reference(seed, n_shards, cap,
                                                      n_ids):
    """Every group renamed to its smallest coordinate + 1 (the streamed x
    sharded chunk's labels)."""
    packed, keys, _, edges = _packed_case(seed, n_shards, cap, n_ids)
    got = reconcile.packed_merge_to_coord_labels(packed, keys, edges, cap,
                                                 n_shards)
    hi, lo = _ref_coords(keys, cap)
    n_e = max(max(len(e) for e in edges), 1)
    e = np.stack([_pad(e.numpy().reshape(-1, 2), n_e, 0) for e in edges])

    def body(core, h, l, ed):
        return ref.packed_merge_to_coord_labels(
            core[0], h[0].astype(jnp.int32), l[0].astype(jnp.int32),
            ed[0].astype(jnp.int32), "z", cap, n_shards,
            encode_stride=PLANE)[None]

    want = _smap(body, n_shards, np.stack([p.numpy() for p in packed]),
                 hi, lo, e)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)


def test_merge_boundary_labels_equals_reference():
    """Four shards of random labels with random overlap-plane pairs: one
    closure over every shard's edges, each shard renamed through it."""
    rng = np.random.default_rng(5)
    n = 4
    labels = np.stack([_random_shard(rng, 40) for _ in range(n)])
    mine = np.stack([_random_shard(rng, 40, (4, 5)) for _ in range(n)])
    theirs = np.stack([_random_shard(rng, 40, (4, 5)) for _ in range(n)])
    want = _smap(lambda l, m, t: ref.merge_boundary_labels(
        l[0], m[0], t[0], "z")[None], n, labels, mine, theirs)
    got = reconcile.merge_boundary_labels(
        [torch.from_numpy(a) for a in labels],
        [torch.from_numpy(a) for a in mine],
        [torch.from_numpy(a) for a in theirs])
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)
    assert (want != labels).any()


def test_boundary_edges_distinct_pairs():
    """The reference's (E, 2) rows, a row a voxel with 0 on the inactive
    ones; with a 0 dropped and duplicates kept once, the distinct pairs."""
    rng = np.random.default_rng(7)
    a, b = _random_shard(rng, 5, (6, 7)), _random_shard(rng, 5, (6, 7))
    rows = np.asarray(ref.boundary_edges(jnp.asarray(a), jnp.asarray(b)))
    want = np.unique(rows[(rows > 0).all(1)], axis=0)
    got = reconcile.boundary_edges(torch.from_numpy(a),
                                   torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, rows)
    np.testing.assert_array_equal(np.unique(got[(got > 0).all(1)], axis=0),
                                  want)


@pytest.mark.parametrize("seed,cap", [(4, 14), (5, 18), (6, 40)])
def test_overflow_count_equals_reference(seed, cap, capsys):
    """Four shards whose core and planes each hold at most 12 ids (so the
    reference's count, taken over candidates truncated to ``cap`` a source,
    is the true one) and whose union may pass ``cap``: ``n_distinct`` is a
    0-d tensor equal to the reference's, and the overflow count
    (``report_overflow``, a pmax) equals the reference's; on the CPU its
    message prints at once, in the reference's words, iff it passes
    ``cap``."""
    rng = np.random.default_rng(seed)
    got, want = [], []
    for _ in range(4):
        core = _random_shard(rng, 12)
        planes = [np.where(p > 0, p + 100 * (k + 1), 0).astype(np.int32)
                  for k, p in enumerate(_random_shard(rng, 12, (4, 5))
                                        for _ in range(2))]
        n_ref = jax.jit(ref.build_local_table, static_argnums=2)(
            jnp.asarray(core), [jnp.asarray(p) for p in planes], cap)[2]
        _, _, n = reconcile.build_local_table(
            torch.from_numpy(core), [torch.from_numpy(p) for p in planes], cap)
        assert n.dim() == 0 and int(n) == int(n_ref)
        got.append(n)
        want.append(int(n_ref))
    c = reconcile.report_overflow(got, cap, reconcile.SHARD_OVERFLOW)
    assert c.dim() == 0 and int(c) == max(want)
    printed = capsys.readouterr().out
    message = reconcile.SHARD_OVERFLOW.format(c=max(want), cap=cap)
    assert (message in printed) == (max(want) > cap)
    # a count on the CPU printed when it was made; nothing is left to print
    assert not reconcile.print_overflow(c, cap, reconcile.SHARD_OVERFLOW)
    assert capsys.readouterr().out == ""


def test_global_compact_overflow_stays_a_tensor(capsys):
    """``global_compact_labels`` keeps its overflow count on the function,
    a 0-d tensor (the largest per-shard distinct count)."""
    labels = [torch.tensor([1, 1, 2, 3, 0], dtype=torch.int32),
              torch.tensor([4, 0, 0, 0, 0], dtype=torch.int32)]
    reconcile.global_compact_labels(labels, 2)
    c = reconcile.global_compact_labels.last_overflow
    assert c.dim() == 0 and int(c) == 3
    assert "a shard has 3 distinct labels > cap 2" in capsys.readouterr().out


def test_reconcile_on_meta_has_fixed_shapes():
    """Every table, edge list and count has a fixed shape: the whole
    reconciliation runs on the meta device, where a host read or a
    data-dependent shape (``unique``, ``nonzero``, boolean indexing)
    raises."""
    cap, n = 8, 3
    core = torch.empty((3, 4, 6), dtype=torch.int32, device="meta")
    table, counts, nd = reconcile.build_local_table(
        core, [core[0], core[:, 0]], cap)
    assert table.shape == counts.shape == (cap,) and nd.shape == ()
    keys = reconcile.global_lin(table, 4, (0, 0), 8, 6)
    packed = reconcile.rename_to_packed(core, table, 1, cap)
    edges = reconcile.boundary_edges(packed[0], packed[1])
    assert edges.shape == (4 * 6, 2)
    c = reconcile.report_overflow([nd] * n, cap, reconcile.SHARD_OVERFLOW)
    assert c.shape == ()
    out = reconcile.packed_compact_labels([packed] * n, [keys] * n,
                                          [counts] * n, [edges] * n, cap, n,
                                          min_size=2)
    assert [o.shape for o in out] == [core.shape] * n
    group, gmin, gval = reconcile.packed_groups(
        [keys] * n, [edges] * n, cap, n, values=[counts.float()] * n)
    assert group.shape == (n * cap + 1,) and gmin.shape == gval.shape == (
        n * cap,)
    assert reconcile.coord_labels(gmin).shape == (n * cap + 1,)
    coord = reconcile.packed_merge_to_coord_labels([packed] * n, [keys] * n,
                                                   [edges] * n, cap, n)
    assert coord[0].shape == core.shape
    compact = reconcile.global_compact_labels([core] * n, cap, min_size=2)
    assert compact[0].shape == core.shape
