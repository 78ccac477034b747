"""Loop-closure detection (port of `tpu3drec/sfm/loopclosure.py`).

Detection is two batched device steps instead of a vocabulary tree:

1. **Candidate proposal**: one global descriptor per frame (the
   L2-normalised mean of its local descriptors, or VLAD over a k-means
   vocabulary of the sequence's own descriptors); the (F, F) cosine
   similarity is one matmul, and pairs above a threshold with
   |i - j| >= min_gap become candidates.
2. **Geometric verification**: all candidate pairs are matched in one call
   of the matcher kernel (`ops/matcher.py`), and the pairs with enough
   mutual-NN matches get a two-view relative pose in one batched
   LO-RANSAC call; enough inliers make a confirmed closure.

Every matmul that feeds an argmax runs in full float32
(``core/fp.py::ieee_fp32``): TF32 would flip near-tied assignments.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu3drec_torch.core import fp
from tpu3drec_torch.sfm.matching import match_pairs
from tpu3drec_torch.sfm.sampling import seeded_generator
from tpu3drec_torch.sfm.twoview import estimate_relative_pose
from tpu3drec_torch.utils.device import resolve_device

_VERIFY_STREAM = 11  # the generator stream of the closures' RANSAC draws


class LoopClosure(NamedTuple):
    i: int
    j: int
    R_rel: np.ndarray   # (3,3) frame_i -> frame_j camera rotation
    t_dir: np.ndarray   # (3,) unit translation direction (scale unknown)
    n_inliers: int
    uv_i: np.ndarray    # (M,2) inlier pixel coords in frame i, kept so that
    uv_j: np.ndarray    # (M,2) consumers can triangulate and, with metric
                        # depth, recover the translation magnitude


def _normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=1e-12)


def global_descriptors(descs: torch.Tensor, valids: torch.Tensor) -> torch.Tensor:
    """(F, K, D) local descriptors -> (F, D) L2-normalised mean pooling."""
    w = valids.to(descs.dtype)[..., None]
    g = torch.sum(descs * w, dim=1) / torch.clamp(torch.sum(w, dim=1), min=1e-6)
    return _normalize(g)


def fit_codebook(descs: torch.Tensor, valids: torch.Tensor, n_words: int = 32,
                 iters: int = 10, seed: int = 0) -> torch.Tensor:
    """K-means visual vocabulary from the sequence's own descriptors:
    Lloyd iterations of two matmuls (assign = argmax similarity, update =
    one-hot matmul), seeded from a strided sample of rows. Returns (V, D)
    centroids."""
    F, K, D = descs.shape
    X = descs.reshape(F * K, D)
    w = valids.reshape(F * K).to(descs.dtype)
    idx = torch.arange(n_words, device=descs.device) * (F * K // n_words)
    C = X[idx]
    words = torch.arange(n_words, device=descs.device)
    with fp.ieee_fp32():
        for _ in range(iters):
            assign = torch.argmax(X @ C.T, dim=1)                        # (N,)
            onehot = (assign[:, None] == words[None]).to(descs.dtype) * w[:, None]
            sums = onehot.T @ X                                          # (V, D)
            counts = torch.sum(onehot, dim=0)[:, None]
            Cn = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), C)
            C = _normalize(Cn, dim=1)
    return C


def vlad_descriptors(descs: torch.Tensor, valids: torch.Tensor,
                     codebook: torch.Tensor) -> torch.Tensor:
    """(F, K, D) -> (F, V*D) VLAD global descriptors (Jegou et al. 2010):
    per visual word, the sum of residuals of the descriptors assigned to
    it, with intra-word L2 and signed-sqrt power normalisation. Assignment
    and accumulation are both batched matmuls."""
    V, D = codebook.shape
    w = valids.to(descs.dtype)
    with fp.ieee_fp32():
        assign = torch.argmax(descs @ codebook.T, dim=2)                     # (F, K)
        words = torch.arange(V, device=descs.device)
        onehot = (assign[..., None] == words).to(descs.dtype) * w[..., None]  # (F, K, V)
        sums = onehot.transpose(1, 2) @ descs                                # (F, V, D)
    counts = torch.sum(onehot, dim=1)[..., None]
    vlad = _normalize(sums - counts * codebook[None], dim=2)
    flat = vlad.reshape(vlad.shape[0], -1)
    flat = torch.sign(flat) * torch.sqrt(torch.abs(flat))
    return _normalize(flat)


def propose_candidates(descs, valids, min_gap: int = 10, sim_threshold: float = 0.85,
                       max_candidates: int = 64, method: str = "mean",
                       vlad_threshold: float = 0.35, n_words: int = 32,
                       per_frame: int = 3) -> np.ndarray:
    """(P, 2) candidate frame pairs by global-descriptor similarity.

    ``method="mean"``: L2-normalised mean pooling. ``method="vlad"``: a
    sequence-local k-means vocabulary and VLAD, whose cosines of unrelated
    views sit near 0, hence the much lower ``vlad_threshold``.

    Selection is per query: each frame contributes its best ``per_frame``
    above-threshold partners (in both directions), then the union is
    ranked by similarity and capped at ``max_candidates``, so a cluster of
    mutually similar views cannot crowd out the revisit pairs of other
    frames."""
    if method == "vlad":
        g = vlad_descriptors(descs, valids, fit_codebook(descs, valids, n_words=n_words))
        thresh = vlad_threshold
    else:
        g = global_descriptors(descs, valids)
        thresh = sim_threshold
    with fp.ieee_fp32():
        S = (g @ g.T).cpu().numpy()
    F = S.shape[0]
    # mask the |i-j| < min_gap band, keep i < j
    mask = np.triu(np.ones((F, F), bool), k=min_gap)
    S_m = np.where(mask, S, -np.inf)
    cand = set()
    k = min(per_frame, F)
    for A in (S_m, S_m.T):
        top = np.argpartition(-A, kth=k - 1, axis=1)[:, :k]
        for i in range(F):
            for j in top[i]:
                s = A[i, j]
                if s >= thresh:
                    cand.add((min(i, int(j)), max(i, int(j)), float(s)))
    if not cand:
        return np.zeros((0, 2), np.int32)
    ranked = sorted(cand, key=lambda x: -x[2])[:max_candidates]
    return np.asarray([(i, j) for i, j, _ in ranked], np.int32)


def detect_loop_closures(descs, valids, keypoints: np.ndarray, K_mat: np.ndarray,
                         min_gap: int = 10, sim_threshold: float = 0.85,
                         min_matches: int = 20, min_inliers: int = 15, ratio: float = 0.85,
                         seed: int = 0, method: str = "mean", vlad_threshold: float = 0.35,
                         samples=None, device=None) -> list[LoopClosure]:
    """Propose, match and verify closures on ``device`` (None means the
    card). ``descs`` (F, K, D), ``valids`` (F, K), ``keypoints`` (F, K, 2).

    The candidates with at least ``min_matches`` matches are verified in one
    batched RANSAC call, whose minimal samples come from a generator seeded
    from ``seed``; ``samples`` (P, S, 8), one row per proposed candidate,
    replaces that draw (tests feed the JAX package's)."""
    dev = resolve_device(device)
    descs = torch.as_tensor(np.asarray(descs, np.float32), device=dev)
    valids = torch.as_tensor(np.asarray(valids, bool), device=dev)
    cands = propose_candidates(descs, valids, min_gap=min_gap, sim_threshold=sim_threshold,
                               method=method, vlad_threshold=vlad_threshold)
    if len(cands) == 0:
        return []
    m = match_pairs(descs, valids, cands, ratio=ratio)
    m_valid = m.valid.cpu().numpy()
    m_ia = m.idx_a.cpu().numpy()
    m_ib = m.idx_b.cpu().numpy()
    keypoints = np.asarray(keypoints, np.float32)
    Kp = descs.shape[1]
    todo = [p for p in range(len(cands)) if m_valid[p].sum() >= min_matches]
    if not todo:
        return []
    uv1 = np.zeros((len(todo), Kp, 2), np.float32)
    uv2 = np.zeros((len(todo), Kp, 2), np.float32)
    vm = np.zeros((len(todo), Kp), bool)
    for q, p in enumerate(todo):
        i, j = cands[p]
        sel = m_valid[p]
        n = int(sel.sum())
        uv1[q, :n] = keypoints[i][m_ia[p][sel]]
        uv2[q, :n] = keypoints[j][m_ib[p][sel]]
        vm[q, :n] = True
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    tv = estimate_relative_pose(
        t(uv1), t(uv2), t(vm), t(np.asarray(K_mat, np.float32)),
        seeded_generator(dev, seed, _VERIFY_STREAM),
        samples=None if samples is None else t(np.asarray(samples)[todo]))
    n_inl = tv.n_inliers.cpu().numpy()
    inliers = tv.inliers.cpu().numpy()
    Rs, ts = tv.R.cpu().numpy(), tv.t.cpu().numpy()
    closures = []
    for q, p in enumerate(todo):
        if int(n_inl[q]) >= min_inliers:
            inl = inliers[q] & vm[q]
            closures.append(LoopClosure(
                i=int(cands[p][0]), j=int(cands[p][1]), R_rel=Rs[q], t_dir=ts[q],
                n_inliers=int(n_inl[q]), uv_i=uv1[q][inl].copy(), uv_j=uv2[q][inl].copy()))
    return closures
