"""Descriptor matching: mutual nearest neighbours + Lowe ratio test (port of
`tpu3drec/sfm/matching.py`).

The matcher kernel (`ops/matcher.py`) is the default route on every
device: the CUDA kernel on the card, its plain version on the CPU. It never
stores the (P, K, K) score tensor. ``use_pallas=False`` keeps the JAX
package's dense formulation (one full-fp32 product per pair, then top-2),
the JAX CPU default, for parity. The flag keeps its reference name.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu3drec_torch.core import fp
from tpu3drec_torch.ops import matcher


class Matches(NamedTuple):
    idx_a: torch.Tensor   # (..., M) indices into A's keypoints
    idx_b: torch.Tensor   # (..., M) indices into B's keypoints
    score: torch.Tensor   # (..., M) similarity of the accepted match
    valid: torch.Tensor   # (..., M) bool


def _top2_desc(scores: torch.Tensor):
    """``lax.top_k(scores, 2)``: the two largest along the last axis, lower
    index first among equal values."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :2], idx[..., :2]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., Ka, D) x b (..., Kb, D)^T in full float32."""
    with fp.ieee_fp32():
        return torch.matmul(a, b.transpose(-1, -2))


def _ratio_ok(s1, s2, ratio, cap=None):
    # ratio test in distance space: d^2 = 2 - 2 s for unit vectors
    d1 = torch.sqrt(torch.clamp(2.0 - 2.0 * s1, min=0.0))
    d2 = torch.sqrt(torch.clamp(2.0 - 2.0 * s2, min=0.0))
    if cap is not None:
        d2 = torch.clamp(d2, max=cap)
    return d1 < ratio * d2


def match_descriptors(desc_a: torch.Tensor, desc_b: torch.Tensor, valid_a=None, valid_b=None,
                      ratio: float = 0.8, use_pallas: bool = True) -> Matches:
    """Mutual-NN matches with ratio test, one row per A keypoint (static
    shape); invalid rows masked. Similarity is the dot product (unit-norm
    descriptors). ``use_pallas`` selects the matcher kernel's route."""
    Ka, Kb = desc_a.shape[0], desc_b.shape[0]
    dev = desc_a.device
    if valid_a is None:
        valid_a = torch.ones(Ka, dtype=torch.bool, device=dev)
    if valid_b is None:
        valid_b = torch.ones(Kb, dtype=torch.bool, device=dev)
    valid_a, valid_b = valid_a.bool(), valid_b.bool()
    if use_pallas:
        best_b, top2 = matcher.topk2_scores(desc_a, desc_b, valid_b)
        best_a_of_b, _ = matcher.topk2_scores(desc_b, desc_a, valid_a)
        best_b, best_a_of_b = best_b.long(), best_a_of_b.long()
        s1, s2 = top2[:, 0], top2[:, 1]
    else:
        scores = _dot(desc_a, desc_b)
        masked = torch.where(valid_b[None, :], scores, -torch.inf)
        top2, top2_idx = _top2_desc(masked)
        best_b = top2_idx[:, 0]
        s1, s2 = top2[:, 0], top2[:, 1]
        scores_t = torch.where(valid_a[None, :], scores.T, -torch.inf)
        best_a_of_b = torch.argmax(scores_t, dim=1)
    ar = torch.arange(Ka, device=dev)
    mutual = best_a_of_b[best_b] == ar
    ok = mutual & _ratio_ok(s1, s2, ratio) & valid_a & torch.isfinite(s1)
    return Matches(idx_a=ar.to(torch.int32), idx_b=best_b.to(torch.int32),
                   score=torch.where(ok, s1, torch.zeros_like(s1)), valid=ok)


def match_pairs(descs: torch.Tensor, valids: torch.Tensor, pairs, ratio: float = 0.8,
                use_pallas: bool = True) -> Matches:
    """Matching over image pairs: descs (F, K, D), valids (F, K), pairs
    (P, 2) -> Matches with (P, K) rows. The kernel route is the default; it
    launches the matcher twice (A against B, B against A)."""
    pairs = torch.as_tensor(pairs, dtype=torch.int64, device=descs.device)
    if use_pallas:
        return _match_pairs_pallas(descs, valids, pairs, ratio)
    outs = [match_descriptors(descs[i], descs[j], valids[i], valids[j], ratio=ratio,
                              use_pallas=False) for i, j in pairs.tolist()]
    return Matches(*(torch.stack(x) for x in zip(*outs)))


def _match_pairs_pallas(descs, valids, pairs, ratio: float) -> Matches:
    K = descs.shape[1]
    A = descs[pairs[:, 0]]
    B = descs[pairs[:, 1]]
    vA = valids[pairs[:, 0]].bool()
    vB = valids[pairs[:, 1]].bool()
    best_b, top2 = matcher.topk2_scores_batched(A, B, vB)
    best_a_of_b, _ = matcher.topk2_scores_batched(B, A, vA)
    s1, s2 = top2[..., 0], top2[..., 1]
    ar = torch.arange(K, device=descs.device)
    mutual = torch.gather(best_a_of_b.long(), 1, best_b.long()) == ar[None, :]
    ok = mutual & _ratio_ok(s1, s2, ratio) & vA & (s1 > -2.0)
    return Matches(idx_a=ar.to(torch.int32)[None, :].expand(best_b.shape),
                   idx_b=best_b.to(torch.int32),
                   score=torch.where(ok, s1, torch.zeros_like(s1)), valid=ok)


def guided_match_pairs(descs: torch.Tensor, valids: torch.Tensor, xy: torch.Tensor, pairs,
                       Es: torch.Tensor, K_mat, band_px: float = 3.0, ratio: float = 0.9,
                       min_sim: float = 0.95) -> Matches:
    """COLMAP-style guided matching: re-match each verified pair inside the
    Sampson band of its essential matrix (x2^T E x1 = 0, normalised
    coordinates) before mutual-NN + ratio; a single in-band candidate passes
    the ratio test, and ``min_sim`` floors the similarity. All pairs in one
    batch: the (P, K, K) products are full-fp32 ``torch.bmm`` (this matcher
    had no Pallas kernel)."""
    dev = descs.device
    pairs = torch.as_tensor(pairs, dtype=torch.int64, device=dev)
    K_mat = torch.as_tensor(K_mat, dtype=torch.float32, device=dev)
    fx, fy = K_mat[0, 0], K_mat[1, 1]
    thresh = (band_px / fx) ** 2

    def norm_h(uv):
        x = (uv[..., 0] - K_mat[0, 2]) / fx
        y = (uv[..., 1] - K_mat[1, 2]) / fy
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)

    i, j = pairs[:, 0], pairs[:, 1]
    da, db = descs[i], descs[j]
    va, vb = valids[i].bool(), valids[j].bool()
    h1, h2 = norm_h(xy[i]), norm_h(xy[j])           # (P, K, 3)
    with fp.ieee_fp32():
        l2 = torch.matmul(h1, Es.transpose(-1, -2))   # epipolar line of a in image 2
        l1 = torch.matmul(h2, Es)                     # epipolar line of b in image 1
        numer = torch.bmm(l2, h2.transpose(1, 2)) ** 2
    denom = (l2[..., 0] ** 2 + l2[..., 1] ** 2)[:, :, None] + \
        (l1[..., 0] ** 2 + l1[..., 1] ** 2)[:, None, :]
    in_band = numer / torch.clamp(denom, min=1e-12) < thresh
    scores = _dot(da, db)
    scores = torch.where(in_band & vb[:, None, :], scores, -torch.inf)
    top2, top2_idx = _top2_desc(scores)
    best_b = top2_idx[..., 0]
    s1, s2 = top2[..., 0], top2[..., 1]
    best_a_of_b = torch.argmax(torch.where(va[:, None, :], scores.transpose(1, 2), -torch.inf),
                               dim=2)
    ar = torch.arange(da.shape[1], device=dev)
    mutual = torch.gather(best_a_of_b, 1, best_b) == ar[None, :]
    ok = (mutual & _ratio_ok(s1, s2, ratio, cap=2.0) & va & torch.isfinite(s1)
          & (s1 >= min_sim))
    return Matches(idx_a=ar.to(torch.int32)[None, :].expand(best_b.shape),
                   idx_b=best_b.to(torch.int32),
                   score=torch.where(ok, s1, torch.zeros_like(s1)), valid=ok)


def sequential_pairs(n_frames: int, overlap: int = 3) -> np.ndarray:
    """COLMAP sequential-matching pair list: each frame against the next
    ``overlap`` frames, as an (P, 2) int32 host array."""
    pairs = [(i, j) for i in range(n_frames)
             for j in range(i + 1, min(i + 1 + overlap, n_frames))]
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)
