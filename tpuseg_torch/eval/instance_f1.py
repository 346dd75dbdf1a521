"""Instance-level evaluation: the port's own copy of
``tpuseg/eval/instance_f1.py`` (numpy and scipy only).

Matches predicted to ground-truth instances either by IoU (optimal one-to-one
assignment via scipy's Hungarian solver on the contingency table) or by the
center-hit criterion (predicted instance contains the GT center), and reports
precision / recall / F1 plus the mean IoU of matched pairs.

Host-side numpy: evaluation is offline and the contingency construction is a
single np.unique over voxel pairs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.optimize import linear_sum_assignment


def _sparse_contingency(pred: np.ndarray, gt: np.ndarray):
    """Sparse contingency between two labelings: O(voxels log voxels) time
    and O(nonzero pairs) memory, where a dense (P x G) table would not fit
    for instance-dense noisy outputs.

    Returns (pred_ids, gt_ids, rows, cols, counts, p_areas, g_areas) where
    (rows[k], cols[k]) index into pred_ids/gt_ids and counts[k] is the
    intersection size |pred_rows[k] ∩ gt_cols[k]|; only co-occurring pairs
    appear. p_areas/g_areas are total voxel counts per id.
    """
    pred = pred.ravel()
    gt = gt.ravel()
    pred_ids, pred_inv = np.unique(pred, return_inverse=True)
    gt_ids, gt_inv = np.unique(gt, return_inverse=True)
    # fuse the two inverse indices into one key per voxel; unique-with-counts
    # gives exactly the nonzero contingency entries
    key = pred_inv.astype(np.int64) * len(gt_ids) + gt_inv
    pair_keys, pair_counts = np.unique(key, return_counts=True)
    rows = pair_keys // len(gt_ids)
    cols = pair_keys % len(gt_ids)
    p_areas = np.bincount(rows, weights=pair_counts, minlength=len(pred_ids))
    g_areas = np.bincount(cols, weights=pair_counts, minlength=len(gt_ids))
    return pred_ids, gt_ids, rows, cols, pair_counts.astype(np.int64), p_areas, g_areas


def voxel_metrics(pred: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
    """Voxel-level foreground agreement between two labelings: Dice / IoU of
    the binarized masks plus the voxel accuracy — the segmentation-quality
    complement to the instance-level F1 (papers in this family report both)."""
    p = np.asarray(pred) > 0
    g = np.asarray(gt) > 0
    inter = float(np.logical_and(p, g).sum())
    ps, gs = float(p.sum()), float(g.sum())
    union = ps + gs - inter
    return {
        "voxel_dice": 2 * inter / (ps + gs) if ps + gs else 1.0,
        "voxel_iou": inter / union if union else 1.0,
        "voxel_accuracy": float((p == g).mean()),
    }


def instance_metrics(
    pred: np.ndarray,
    gt: np.ndarray,
    iou_threshold: float = 0.5,
    criterion: str = "iou",
) -> Dict[str, float]:
    """criterion: "iou" (Hungarian on IoU >= threshold) or "center"
    (predicted instance containing the GT instance's centroid)."""
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    pred_ids, gt_ids, rows, cols, counts, p_areas_all, g_areas_all = (
        _sparse_contingency(pred, gt))

    n_pred = int((pred_ids > 0).sum())
    n_gt = int((gt_ids > 0).sum())
    if n_pred == 0 or n_gt == 0:
        tp = 0
        mean_iou = 0.0
    elif criterion == "iou":
        # keep only fg-fg co-occurrences
        fg_pair = (pred_ids[rows] > 0) & (gt_ids[cols] > 0)
        r, c, n = rows[fg_pair], cols[fg_pair], counts[fg_pair].astype(np.float64)
        union = p_areas_all[r] + g_areas_all[c] - n
        iou = np.where(union > 0, n / union, 0.0)
        if iou_threshold >= 0.5:
            # IoU >= 0.5 pairs are mutually exclusive (two instances cannot
            # each cover >half of the same partner), so the optimal matching
            # is exactly the set of above-threshold pairs — no Hungarian, no
            # dense table; this path is safe on instance-dense GVoxel outputs.
            matched = iou >= iou_threshold
            tp = int(matched.sum())
            mean_iou = float(iou[matched].mean()) if tp else 0.0
        else:
            # below 0.5 optimal 1-1 assignment needs the Hungarian solver;
            # densify only the co-occurring submatrix
            up, ui = np.unique(r, return_inverse=True)
            ug, uj = np.unique(c, return_inverse=True)
            dense = np.zeros((len(up), len(ug)), np.float64)
            dense[ui, uj] = iou
            rr, cc = linear_sum_assignment(-dense)
            matched = dense[rr, cc] >= iou_threshold
            tp = int(matched.sum())
            mean_iou = float(dense[rr, cc][matched].mean()) if tp else 0.0
    elif criterion == "center":
        # Optimality note: each GT center lies in
        # EXACTLY ONE predicted instance (labels partition the volume), so
        # every GT node has degree <= 1 in the match graph and the maximum
        # bipartite matching size is simply the number of DISTINCT predicted
        # ids claimed — which the first-come claim below attains for ANY
        # iteration order. Only the identity of the matched GT within a
        # multi-center pred depends on order, and identities are not
        # returned; tp/precision/recall/F1 are order-invariant.
        # one-pass centroids: accumulate per-instance coordinate sums with
        # np.add.at instead of a full-volume argwhere per GT instance
        flat = gt.ravel()
        _, inv = np.unique(flat, return_inverse=True)  # inv indexes gt_ids
        lin = np.arange(flat.size, dtype=np.int64)
        hw = gt.shape[1] * gt.shape[2]
        k = len(gt_ids)
        counts = np.bincount(inv, minlength=k).astype(np.int64)
        sums = np.stack([
            np.bincount(inv, weights=lin // hw, minlength=k),
            np.bincount(inv, weights=(lin % hw) // gt.shape[2], minlength=k),
            np.bincount(inv, weights=lin % gt.shape[2], minlength=k),
        ], axis=-1)
        hits = set()
        used_pred = set()
        for j, gid in enumerate(gt_ids):
            if gid <= 0:
                continue
            cz, cy, cx = np.round(sums[j] / counts[j]).astype(int)
            pid = pred[cz, cy, cx]
            if pid > 0 and pid not in used_pred:
                hits.add(gid)
                used_pred.add(pid)
        tp = len(hits)
        mean_iou = float("nan")
    else:
        raise ValueError(f"unknown criterion {criterion!r}")

    fp = n_pred - tp
    fn = n_gt - tp
    precision = tp / n_pred if n_pred else 0.0
    recall = tp / n_gt if n_gt else 0.0
    f1 = 2 * precision * recall / (precision + recall) if (precision + recall) else 0.0
    return {
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "n_pred": n_pred,
        "n_gt": n_gt,
        "mean_matched_iou": mean_iou,
    }


def center_match_f1(labels, centers, n_pred: int | None = None) -> Dict[str, float]:
    """Center-criterion instance F1 against known GT centers, using only
    POINT READS of ``labels`` — works on GVoxel-scale memmaps where even the
    sparse contingency of :func:`instance_metrics` would have to scan every
    voxel.

    A GT instance scores a hit when the predicted instance containing its
    (rounded) center has not already been claimed by another GT center.
    ``n_pred`` defaults to a streamed max over z-slabs of ``labels``.

    tp is the MAXIMUM bipartite matching for any iteration order: each GT
    center lies in exactly one predicted instance (labels partition the
    volume), so the matching size equals the number of distinct claimed
    preds — see the criterion="center" note in :func:`instance_metrics`.
    """
    centers = np.asarray(centers)
    if n_pred is None:
        n_pred = 0
        for z0 in range(0, labels.shape[0], 64):
            n_pred = max(n_pred, int(np.max(labels[z0:z0 + 64])))
    used = set()
    tp = 0
    for c in np.round(centers).astype(int):
        c = np.clip(c, 0, np.asarray(labels.shape) - 1)
        pid = int(labels[c[0], c[1], c[2]])
        if pid > 0 and pid not in used:
            used.add(pid)
            tp += 1
    n_gt = len(centers)
    precision = tp / n_pred if n_pred else 0.0
    recall = tp / n_gt if n_gt else 0.0
    f1 = 2 * precision * recall / (precision + recall) if (precision + recall) else 0.0
    return {"precision": precision, "recall": recall, "f1": f1,
            "tp": tp, "n_pred": n_pred, "n_gt": n_gt}
