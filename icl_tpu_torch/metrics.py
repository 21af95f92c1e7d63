"""Binary Dice + HD95 with the reference's empty-mask sentinels (a copy of
`icl_tpu/metrics.py:21-79`, medpy semantics, computed with scipy on the
host):

    pred and gt both empty      -> (dice 1, hd95 0)
    exactly one of them empty   -> (dice 0, hd95 373.128664)

and the reference's other metrics, which no evaluation calls
(`icl_tpu/metrics.py:81-136`): pixel accuracy, mean IoU, the binary
Jaccard index and `evaluate_seg`.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage

EMPTY_SENTINEL_HD95 = 373.128664


def dice_binary(pred: np.ndarray, gt: np.ndarray) -> float:
    """2|A n B| / (|A| + |B|), as medpy.metric.binary.dc."""
    pred = np.asarray(pred).astype(bool)
    gt = np.asarray(gt).astype(bool)
    size_sum = np.count_nonzero(pred) + np.count_nonzero(gt)
    if size_sum == 0:
        return 0.0
    return 2.0 * np.count_nonzero(pred & gt) / float(size_sum)


def _surface_distances(result, reference, voxelspacing=None, connectivity: int = 1) -> np.ndarray:
    """Distances from the border voxels of `result` to the border of
    `reference` (medpy __surface_distances)."""
    result = np.atleast_1d(np.asarray(result).astype(bool))
    reference = np.atleast_1d(np.asarray(reference).astype(bool))
    footprint = ndimage.generate_binary_structure(result.ndim, connectivity)
    if not np.any(result):
        raise RuntimeError("result is empty; surface distance undefined")
    if not np.any(reference):
        raise RuntimeError("reference is empty; surface distance undefined")
    result_border = result ^ ndimage.binary_erosion(result, structure=footprint, iterations=1)
    reference_border = reference ^ ndimage.binary_erosion(reference, structure=footprint, iterations=1)
    dt = ndimage.distance_transform_edt(~reference_border, sampling=voxelspacing)
    return dt[result_border]


def hd95_binary(pred: np.ndarray, gt: np.ndarray, voxelspacing=None) -> float:
    """95th-percentile symmetric Hausdorff distance, as medpy hd95."""
    hd1 = _surface_distances(pred, gt, voxelspacing)
    hd2 = _surface_distances(gt, pred, voxelspacing)
    return float(np.percentile(np.hstack((hd1, hd2)), 95))


def calculate_metric_percase(pred: np.ndarray, gt: np.ndarray) -> tuple[float, float]:
    """(dice, hd95) for one binary class, with the reference sentinels."""
    pred = np.asarray(pred) > 0
    gt = np.asarray(gt) > 0
    pred_any = bool(pred.any())
    gt_any = bool(gt.any())
    if pred_any and gt_any:
        return dice_binary(pred, gt), hd95_binary(pred, gt)
    if pred_any != gt_any:
        return 0.0, EMPTY_SENTINEL_HD95
    return 1.0, 0.0


def aggregate_case_metrics(metric_cal: list[list[tuple[float, float]]]) -> dict:
    """Per-class mean and std over cases of (dice, hd95), then the mean
    over classes (a copy of `icl_tpu/metrics.py:aggregate_case_metrics`).
    Returns mean_dice, mean_hd95, std_dice, std_hd95, class_mean and
    class_std (each class entry an array [dice, hd95])."""
    num_fg = len(metric_cal)
    mean_cal = 0.0
    std_cal = 0.0
    class_mean, class_std = [], []
    for per_case in metric_cal:
        arr = np.asarray(per_case, dtype=np.float64)
        mean_cal = mean_cal + arr.mean(axis=0)
        std_cal = std_cal + arr.std(axis=0)
        class_mean.append(arr.mean(axis=0))
        class_std.append(arr.std(axis=0))
    return {
        "mean_dice": float(mean_cal[0] / num_fg),
        "mean_hd95": float(mean_cal[1] / num_fg),
        "std_dice": float(std_cal[0] / num_fg),
        "std_hd95": float(std_cal[1] / num_fg),
        "class_mean": class_mean,
        "class_std": class_std,
    }


def pixel_accuracy(pred: np.ndarray, gt: np.ndarray) -> float:
    """The share of labeled (gt >= 0) pixels predicted right."""
    pred, gt = np.asarray(pred), np.asarray(gt)
    labeled = gt >= 0
    return np.count_nonzero((pred == gt) & labeled) / max(1, np.count_nonzero(labeled))


def mean_iou(pred: np.ndarray, gt: np.ndarray, num_classes: int) -> float:
    """The mean IoU over the classes present in gt or pred (0 when none is)."""
    pred, gt = np.asarray(pred), np.asarray(gt)
    ious = []
    for c in range(num_classes):
        p, g = pred == c, gt == c
        union = np.count_nonzero(p | g)
        if union:
            ious.append(np.count_nonzero(p & g) / union)
    return float(np.mean(ious)) if ious else 0.0


def jaccard_binary(pred: np.ndarray, gt: np.ndarray) -> float:
    """|A n B| / |A u B| (medpy.metric.binary.jc); 0 when both are empty."""
    pred = np.asarray(pred).astype(bool)
    gt = np.asarray(gt).astype(bool)
    union = np.count_nonzero(pred | gt)
    return np.count_nonzero(pred & gt) / union if union else 0.0


def evaluate_seg(pred: np.ndarray, gt: np.ndarray) -> tuple[float, float, float]:
    """(MAE, Dice, IoU) of soft binary maps thresholded at 0.5, the
    reference's `evaluate_seg` with its quirk: a true-positive count of 0
    is taken as 1, so an all-negative prediction of a positive gt still
    scores a nonzero Dice and IoU."""
    pred_b = (np.asarray(pred, np.float64) >= 0.5).astype(np.float64)
    gt_b = (np.asarray(gt, np.float64) >= 0.5).astype(np.float64)
    mae = float(np.abs(pred_b - gt_b).mean())
    tp = float((pred_b * gt_b).sum()) or 1.0
    fp = float((pred_b * (1.0 - gt_b)).sum())
    fn = float(((1.0 - pred_b) * gt_b).sum())
    recall, precision = tp / (tp + fn), tp / (tp + fp)
    return mae, 2.0 * precision * recall / (precision + recall), tp / (tp + fp + fn)
