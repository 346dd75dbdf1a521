"""Connected components by parallel union-find (port of
``tpuseg/ops/components.py``).

Rounds of two steps, as in the JAX package: ``jump_rounds`` pointer jumps
``p = p[p]``, then for every 6-neighbourhood edge inside the mask a
scatter-min of the smaller root onto the larger root's parent slot. A
changed flag, read on the host after each round, ends the loop at the fixed
point (or after ``ceil(log2 n) + 4`` rounds). A sentinel slot ``n`` absorbs
background. Labels are the component's smallest linear index + 1.

``union_closure`` is the same closure over a host edge list (numpy): the
streamed path joins its chunks' ids with it, and ``labels_are_connected``
its per-chunk components.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpuseg_torch.ops.neighbors import shift

#: positive-direction neighbours; each undirected edge is visited once
_POS_DIRS = ((0, 1), (1, 1), (2, 1))


def union_closure(edges: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Union-find closure over an (E, 2) int64 edge list of label values ->
    ``(keys, reps)`` rename table: values compacted to positions, scatter-min
    hooks (``np.minimum.at``), pointer-jump compression. O(E log E)."""
    if len(edges) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    keys = np.unique(edges)
    a = np.searchsorted(keys, edges[:, 0])
    b = np.searchsorted(keys, edges[:, 1])
    parent = np.arange(len(keys), dtype=np.int64)
    for _ in range(max(2, int(np.ceil(np.log2(max(len(keys), 2)))) + 1)):
        ra, rb = parent[a], parent[b]
        hi, lo = np.maximum(ra, rb), np.minimum(ra, rb)
        np.minimum.at(parent, hi, lo)
        parent = parent[parent[parent]]
    return keys, keys[parent]


def rename(vals: np.ndarray, keys: np.ndarray, reps: np.ndarray) -> np.ndarray:
    """``vals`` through a ``union_closure`` table (values not in it stay)."""
    if len(keys) == 0:
        return vals
    pos = np.clip(np.searchsorted(keys, vals), 0, len(keys) - 1)
    return np.where(keys[pos] == vals, reps[pos], vals)


def _union_find(mask: torch.Tensor, labels, jump_rounds: int) -> torch.Tensor:
    """Component labels of ``mask``; with ``labels``, an edge joins only
    equal labels."""
    shape, n = mask.shape, mask.numel()
    idx = torch.arange(n, device=mask.device)
    p = torch.cat([torch.where(mask.reshape(-1), idx, n),
                   torch.full((1,), n, device=mask.device)])
    max_rounds = math.ceil(math.log2(max(n, 2))) + 4

    def compress(q):
        for _ in range(jump_rounds):
            q = q[q]
        return q

    for _ in range(max_rounds):
        new = compress(p)
        roots = new[:-1].reshape(shape)
        for axis, off in _POS_DIRS:
            rn = shift(roots, axis, off, n)
            valid = (roots < n) & (rn < n)
            if labels is not None:
                valid &= labels == shift(labels, axis, off, 0)
            hi = torch.where(valid, torch.maximum(roots, rn), n).reshape(-1)
            lo = torch.where(valid, torch.minimum(roots, rn), n).reshape(-1)
            new = new.scatter_reduce(0, hi, lo, "amin")
        if torch.equal(new, p):
            break
        p = new
    p = compress(p)
    out = torch.where(mask, p[:-1].reshape(shape) + 1, 0)
    return out.to(torch.int32) if n < 2 ** 31 else out


def connected_components(mask: torch.Tensor,
                         jump_rounds: int = 8) -> torch.Tensor:
    """Labels of the 6-connected components of ``mask`` (int32 while the
    volume has fewer than 2^31 voxels): smallest linear index + 1 on the
    mask, 0 off it."""
    return _union_find(mask.bool(), None, jump_rounds)


def label_components(labels: torch.Tensor,
                     jump_rounds: int = 8) -> torch.Tensor:
    """Connected components of a label volume: edges join 6-neighbours with
    equal non-zero labels. Returns smallest linear index + 1."""
    return _union_find(labels > 0, labels, jump_rounds)


def labels_are_connected(labels, device="cuda",
                         chunk_z: int | None = None) -> bool:
    """True iff every non-zero label forms one 6-connected component (the
    check of ``cli.infer --validate``). ``labels``: a tensor, or an array
    that is moved to ``device``. A component holds one label only, so the
    labels are connected iff they and their components are equally many.

    With ``chunk_z``, an array (an ``np.memmap`` too) goes to ``device``
    ``chunk_z`` planes at a time: components per chunk, joined across each
    seam where the two planes hold the same label, by ``union_closure`` on
    the host. Device memory then follows the chunk, not the volume."""
    if chunk_z is None or isinstance(labels, torch.Tensor):
        if not isinstance(labels, torch.Tensor):
            labels = torch.from_numpy(np.asarray(labels)).to(device)
        fg = labels > 0
        comps = label_components(labels)
        return (torch.unique(comps[fg]).numel()
                == torch.unique(labels[fg]).numel())
    D, H, W = labels.shape
    comp_chunks, label_chunks, edges = [], [], []
    last = None              # the previous chunk's last plane: labels, comps
    for z0 in range(0, D, chunk_z):
        lab = torch.from_numpy(np.array(labels[z0:z0 + chunk_z])).to(device)
        comps = label_components(lab).long()
        ids = torch.unique(comps[lab > 0])            # local, ascending
        off = np.int64(z0) * H * W
        comp_chunks.append(ids.cpu().numpy() + off)
        label_chunks.append(lab.reshape(-1)[ids - 1].cpu().numpy())
        first = (lab[0].cpu().numpy(), comps[0].cpu().numpy() + off)
        if last is not None:
            join = (first[0] > 0) & (first[0] == last[0])
            edges.append(np.stack([last[1][join], first[1][join]], axis=-1))
        last = (lab[-1].cpu().numpy(), comps[-1].cpu().numpy() + off)
        del lab, comps, ids
    edges = np.concatenate(edges) if edges else np.zeros((0, 2), np.int64)
    roots = rename(np.concatenate(comp_chunks), *union_closure(edges))
    labels_seen = np.unique(np.concatenate(label_chunks))
    return len(np.unique(roots)) == len(labels_seen)
