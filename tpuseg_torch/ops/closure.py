"""Union-find closure of an edge list on the device (U1, ``csrc/closure.cu``).

The JAX package closes its saddle-merge edges and its cross-shard rename
edges inside its programs: a sorted key table, scatter-min hooks and
pointer jumps for ``ceil(log2 m) + 1`` rounds
(``tpuseg/parallel/reconcile.py:41-78``, ``tpuseg/ops/merge.py:136-152``).
There is no Pallas kernel for it. Here the key table is built the same way
(``torch.sort``, ``torch.searchsorted``), and a hand-written lock-free
union-find closes it to its fixed point in two launches, with no host read:

* ``union_closure`` (U1) — the wrapper. A CUDA tensor launches the kernel or
  raises; a CPU tensor takes the plain twin. ``.launches`` counts the calls
  that launched it (two kernels each).
* ``union_closure_plain`` — the twin: scatter-min hooks and pointer jumps in
  plain PyTorch, run to their fixed point (a host read a round).

On the meta device the wrapper returns the table's shapes only (a meta
tensor holds no values): the CPU tests run the fixed-size callers there,
where any data-dependent shape or host read raises.
"""

from __future__ import annotations

import torch

from tpuseg_torch.ops import _build

#: the key of an unused table slot, by endpoint dtype: after every value
SENTINELS = {torch.int32: 2 ** 31 - 1, torch.int64: 2 ** 63 - 1}


def _table(u: torch.Tensor, v: torch.Tensor):
    """``(keys, pu, pv, parent)``: the sorted endpoint values of the active
    edges (sentinel-padded, 2E slots), each endpoint's first slot in them
    (int32, -1 for an inactive edge), and the starting forest (int32), in
    which a repeated key's slot points at its first copy."""
    if u.dim() != 1 or u.shape != v.shape or u.dtype != v.dtype \
            or u.dtype not in SENTINELS:
        raise ValueError(f"union_closure needs two 1-D int32/int64 endpoint "
                         f"tensors of one length, got {u.dtype} "
                         f"{tuple(u.shape)} and {v.dtype} {tuple(v.shape)}")
    sent = SENTINELS[u.dtype]
    active = (u > 0) & (v > 0) & (u != sent) & (v != sent)
    keys = torch.sort(torch.cat([torch.where(active, u, sent),
                                 torch.where(active, v, sent)])).values
    if keys.numel() >= 2 ** 31:
        raise ValueError(f"union_closure: {keys.numel()} slots exceed the "
                         "int32 forest")
    pu = torch.where(active, torch.searchsorted(keys, u, out_int32=True), -1)
    pv = torch.where(active, torch.searchsorted(keys, v, out_int32=True), -1)
    parent = torch.searchsorted(keys, keys, out_int32=True)
    return keys, pu, pv, parent


def union_closure_plain(u: torch.Tensor, v: torch.Tensor):
    """Twin of :func:`union_closure`: scatter-min hooks of the larger root
    under the smaller and pointer jumps to a flat forest, round after round
    until a round changes nothing."""
    keys, pu, pv, parent = _table(u, v)
    m = keys.numel()
    # inactive edges hook a dummy slot m onto itself
    hu = torch.where(pu >= 0, pu, m).long()
    hv = torch.where(pv >= 0, pv, m).long()
    parent = torch.cat([parent.long(), torch.full((1,), m,
                                                  device=keys.device)])
    while True:
        ru, rv = parent[hu], parent[hv]
        hooked = parent.scatter_reduce(0, torch.maximum(ru, rv),
                                       torch.minimum(ru, rv), "amin")
        while True:                      # compress to a flat forest
            jumped = hooked[hooked]
            if torch.equal(jumped, hooked):
                break
            hooked = jumped
        if torch.equal(hooked, parent):
            break
        parent = hooked
    return keys, keys[parent[:m]]


def union_closure(u: torch.Tensor, v: torch.Tensor):
    """``(keys, reps)`` of the edges ``(u[i], v[i])`` over label values:
    ``keys`` the 2E endpoint values of the active edges, ascending, padded
    with the dtype's sentinel (``SENTINELS``); ``reps[i]`` the smallest
    value reachable from ``keys[i]`` (the sentinel for a padding slot). An
    edge with a 0 or a sentinel endpoint is inactive. Look values up with
    ``searchsorted`` (every copy of a key holds its group's smallest
    value)."""
    if u.device.type == "cpu":
        return union_closure_plain(u, v)
    keys, pu, pv, parent = _table(u, v)
    if keys.device.type == "meta":
        return keys, torch.empty_like(keys)
    if not keys.is_cuda:
        raise ValueError(f"union_closure needs CUDA or CPU tensors, got "
                         f"{keys.device}")
    reps = torch.empty_like(keys)
    if keys.numel() == 0:
        return keys, reps
    err = _build.load().tpuseg_union_closure(
        pu.data_ptr(), pv.data_ptr(), pu.numel(), parent.data_ptr(),
        keys.data_ptr(), reps.data_ptr(), keys.numel(), keys.element_size(),
        _build.stream_ptr())
    _build.check(err, "union_closure")
    union_closure.launches += 1
    return keys, reps


union_closure.launches = 0
