"""Edge-detection evaluation: ODS / OIS / AP.

A copy of ``dexiraft_tpu/dexined/metrics.py`` (numpy and scipy; cv2 only
inside the dilation surrogate).

The reference reports these for DexiNed on BIPED (core/DexiNed/README.md,
BASELINE.md) but computes them with an external MATLAB/BSDS toolbox; here
they are first-class, with the toolbox's matching rule implemented
exactly:

  * ``matching="assignment"`` (default) — the BSDS correspondPixels
    protocol. A predicted edge pixel is a true positive iff it is paired
    with a distinct ground-truth edge pixel within ``tolerance * diag``
    (Euclidean); the pairing is ONE-TO-ONE, so a cluster of predictions
    around a single GT pixel yields one TP, not many. correspondPixels
    solves a min-cost assignment with an outlier cost, whose matched
    COUNT (the only thing entering P/R) equals the maximum-cardinality
    bipartite matching on the within-tolerance graph — computed here
    with a KD-tree neighborhood graph + Hopcroft-Karp. Verified against
    a brute-force assignment in tests/test_edge_metrics.py.
  * ``matching="dilation"`` — the fast morphological surrogate (a pred
    pixel counts if ANY GT pixel is within tolerance, and symmetrically
    for recall). Upper-bounds the assignment scores; the bias is
    quantified in docs/parity.md. Use for quick in-training validation.

As in the toolbox, predictions should be thinned/NMS'd beforehand (the
reference pipeline applies NMS before evaluation, DexiNed README:123-140);
thick unthinned boundaries lower assignment-precision by construction.

  ODS: best F-measure over thresholds with ONE dataset-wide threshold
  OIS: mean of each image's best F-measure
  AP:  area under the dataset precision-recall curve
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

DEFAULT_THRESHOLDS = np.linspace(0.01, 0.99, 33)


def _dilate(mask: np.ndarray, radius: int) -> np.ndarray:
    if radius <= 0:
        return mask
    import cv2

    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
                                       (2 * radius + 1, 2 * radius + 1))
    return cv2.dilate(mask.astype(np.uint8), kernel).astype(bool)


def _tolerance_radius(shape: Sequence[int], frac: float = 0.0075) -> float:
    """BSDS maxDist: fraction of the image diagonal (Euclidean, float)."""
    return max(1.0, frac * float(np.hypot(shape[0], shape[1])))


def match_count(pred_mask: np.ndarray, gt_mask: np.ndarray,
                radius: float, gt_tree=None) -> int:
    """Maximum number of one-to-one (pred pixel, GT pixel) pairs within
    Euclidean ``radius`` — the correspondPixels matched count.

    Maximum-cardinality matching via Hopcroft-Karp on the KD-tree
    neighborhood graph; exact, and sparse enough to scale to real edge
    maps (edges only between pixels closer than a few px). ``gt_tree``
    lets a threshold sweep reuse one (n_gt, cKDTree) build per image."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_bipartite_matching
    from scipy.spatial import cKDTree

    pred_pts = np.argwhere(pred_mask)
    if gt_tree is None:
        gt_pts = np.argwhere(gt_mask)
        gt_tree = cKDTree(gt_pts) if len(gt_pts) else None
    n_gt = gt_tree.n if gt_tree is not None else 0
    if len(pred_pts) == 0 or n_gt == 0:
        return 0
    pairs = cKDTree(pred_pts).query_ball_tree(gt_tree, r=radius)
    indptr = np.zeros(len(pred_pts) + 1, np.int64)
    indptr[1:] = np.cumsum([len(p) for p in pairs])
    indices = np.fromiter((j for p in pairs for j in p), np.int64,
                          count=indptr[-1])
    graph = csr_matrix(
        (np.ones(len(indices), np.uint8), indices, indptr),
        shape=(len(pred_pts), n_gt))
    match = maximum_bipartite_matching(graph, perm_type="column")
    return int((match >= 0).sum())


def edge_counts(pred: np.ndarray, gt: np.ndarray,
                thresholds: np.ndarray = DEFAULT_THRESHOLDS,
                tolerance: float = 0.0075,
                matching: str = "assignment") -> np.ndarray:
    """Per-threshold match counts for one image.

    pred: (H, W) probabilities in [0, 1]; gt: (H, W) binary edge map.
    Returns (T, 4) int64 columns [tp, n_pred, matched_gt, n_gt].
    """
    if matching not in ("assignment", "dilation"):
        raise ValueError(f"unknown matching {matching!r}; "
                         "expected 'assignment' or 'dilation'")
    pred = np.asarray(pred, np.float32)
    gt = np.asarray(gt) > 0.5
    r = _tolerance_radius(pred.shape, tolerance)
    n_gt = int(gt.sum())
    if matching == "dilation":
        gt_dil = _dilate(gt, int(round(r)))
    else:
        # GT is loop-invariant across the threshold sweep: one tree build
        from scipy.spatial import cKDTree

        gt_tree = cKDTree(np.argwhere(gt)) if n_gt else None

    out = np.zeros((len(thresholds), 4), np.int64)
    for i, t in enumerate(thresholds):
        p = pred >= t
        n_pred = int(p.sum())
        if matching == "assignment":
            # one-to-one: matched pred count == matched GT count
            tp = matched_gt = match_count(p, gt, r, gt_tree=gt_tree)
        else:
            tp = int((p & gt_dil).sum())  # predictions near a GT edge
            p_dil = _dilate(p, int(round(r)))
            matched_gt = int((gt & p_dil).sum())  # GT edges found
        out[i] = (tp, n_pred, matched_gt, n_gt)
    return out


def _prf(tp: float, n_pred: float, matched: float, n_gt: float
         ) -> Tuple[float, float, float]:
    precision = tp / n_pred if n_pred else 0.0
    recall = matched / n_gt if n_gt else 0.0
    f = (2 * precision * recall / (precision + recall)
         if precision + recall else 0.0)
    return precision, recall, f


def evaluate_edges(preds: Sequence[np.ndarray], gts: Sequence[np.ndarray],
                   thresholds: np.ndarray = DEFAULT_THRESHOLDS,
                   tolerance: float = 0.0075,
                   matching: str = "assignment") -> Dict[str, float]:
    """ODS / OIS / AP over a dataset of (probability map, binary GT)."""
    return evaluate_from_counts(
        [edge_counts(p, g, thresholds, tolerance, matching)
         for p, g in zip(preds, gts)],
        thresholds)


def evaluate_from_counts(per_image: Sequence[np.ndarray],
                         thresholds: np.ndarray = DEFAULT_THRESHOLDS
                         ) -> Dict[str, float]:
    """Score from per-image (T, 4) count matrices (edge_counts) — lets a
    streaming caller hold O(T) state per image instead of full maps."""
    totals = np.sum(per_image, axis=0)  # (T, 4)

    # ODS: one threshold for the whole dataset
    dataset_f = [_prf(*totals[i])[2] for i in range(len(thresholds))]
    ods = float(np.max(dataset_f))

    # OIS: per-image best threshold
    ois_scores = [max(_prf(*c[i])[2] for i in range(len(thresholds)))
                  for c in per_image]
    ois = float(np.mean(ois_scores)) if ois_scores else 0.0

    # AP: area under the dataset PR curve (recall-sorted trapezoid,
    # anchored at recall 0 with the lowest-recall precision so a
    # single-point curve still integrates)
    pr = np.array([_prf(*totals[i])[:2] for i in range(len(thresholds))])
    order = np.argsort(pr[:, 1])
    recall_sorted = np.concatenate([[0.0], pr[order, 1]])
    precision_sorted = np.concatenate([[pr[order[0], 0]], pr[order, 0]])
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy<2
    ap = float(trapezoid(precision_sorted, recall_sorted))

    return {"ODS": ods, "OIS": ois, "AP": ap}
