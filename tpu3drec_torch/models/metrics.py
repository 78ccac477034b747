"""Depth evaluation metrics (port of `tpu3drec/models/metrics.py`).

The seven standard metrics (abs_rel, sq_rel, rmse, rmse_log, a1/a2/a3)
with per-image median scaling against ground truth and a [min, max] depth
clamp; no Eigen/Garg crop, as in the reference's InteriorNet setting.
"""

from __future__ import annotations

import torch


def compute_depth_errors(pred: torch.Tensor, gt: torch.Tensor) -> dict:
    """Per-element metric terms; reduce under the caller's mask."""
    thresh = torch.maximum(gt / pred, pred / gt)
    return {
        "a1": (thresh < 1.25).float(),
        "a2": (thresh < 1.25 ** 2).float(),
        "a3": (thresh < 1.25 ** 3).float(),
        "abs_rel": torch.abs(gt - pred) / gt,
        "sq_rel": (gt - pred) ** 2 / gt,
        "rmse_term": (gt - pred) ** 2,
        "rmse_log_term": (torch.log(gt) - torch.log(pred)) ** 2,
    }


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The JAX package's median over the masked entries: the sorted value at
    n // 2, the upper median for even n (``torch.median`` takes the lower)."""
    n = int(mask.sum())
    s = torch.sort(torch.where(mask, x, torch.inf).reshape(-1)).values
    return s[min(n // 2, s.numel() - 1)]


def depth_metrics(pred: torch.Tensor, gt: torch.Tensor, min_depth: float = 1e-3,
                  max_depth: float = 80.0) -> dict:
    """Batch depth metrics: per image, pred *= median(gt) / median(pred) over
    the valid mask (gt > min_depth), then clamped to [min_depth,
    max_depth]; the mean over images of each metric (0-dim tensors)."""
    per = []
    for p, g in zip(pred, gt):
        mask = g > min_depth
        p = p * _masked_median(g, mask) / torch.clamp(_masked_median(p, mask), min=1e-12)
        p = torch.clamp(p, min_depth, max_depth)
        terms = compute_depth_errors(torch.where(mask, p, 1.0), torch.where(mask, g, 1.0))
        n = torch.clamp(mask.sum(), min=1)

        def masked_mean(key):
            return torch.sum(torch.where(mask, terms[key], 0.0)) / n

        out = {k: masked_mean(k) for k in ("a1", "a2", "a3", "abs_rel", "sq_rel")}
        out["rmse"] = torch.sqrt(masked_mean("rmse_term"))
        out["rmse_log"] = torch.sqrt(masked_mean("rmse_log_term"))
        per.append(out)
    return {k: torch.stack([o[k] for o in per]).mean() for k in per[0]}
