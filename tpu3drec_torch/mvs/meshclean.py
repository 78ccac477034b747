"""Mesh cleanup, the MVE ``meshclean`` analogue (port of
`tpu3drec/mvs/meshclean.py`): drop small isolated components (noisy depth
that survived the consistency filter fuses into small floating shells) and
unreferenced vertices.

Host-side by design: connected components over a sparse graph is
irregular pointer chasing. The union-find below is numpy-vectorised with
path halving, O(E alpha) in ~10 passes over the edge list.
"""

from __future__ import annotations

import numpy as np


def _connected_components(n_verts: int, edges: np.ndarray) -> np.ndarray:
    """Vertex component labels (each the smallest vertex of its
    component) by vectorised union-find."""
    parent = np.arange(n_verts, dtype=np.int64)
    if edges.size == 0:
        return parent
    a = edges[:, 0].astype(np.int64)
    b = edges[:, 1].astype(np.int64)
    # hook and compress until stable: each pass links every edge's current
    # roots; converges in O(log V) passes
    for _ in range(64):
        ra, rb = parent[a], parent[b]
        lo = np.minimum(ra, rb)
        hi = np.maximum(ra, rb)
        changed = bool(np.any(lo != hi))
        if changed:
            # hook the larger root to the smaller (minimum.at resolves
            # races deterministically toward the minimum)
            np.minimum.at(parent, hi, lo)
        while True:  # path compression
            gp = parent[parent]
            if np.array_equal(gp, parent):
                break
            parent = gp
        if not changed:
            break
    return parent


def clean_mesh(verts: np.ndarray, faces: np.ndarray, min_component_frac: float = 0.02,
               min_component_faces: int = 10):
    """Drop connected components with fewer faces than
    max(min_component_frac of all faces, min_component_faces) (keeping the
    largest if every one is smaller), then unreferenced vertices. Returns
    (verts, faces) reindexed."""
    if faces.shape[0] == 0:
        return verts[:0], faces
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    labels = _connected_components(verts.shape[0], edges)
    face_label = labels[faces[:, 0]]
    uniq, counts = np.unique(face_label, return_counts=True)
    thresh = max(int(min_component_frac * faces.shape[0]), int(min_component_faces))
    keep_labels = uniq[counts >= thresh]
    if keep_labels.size == 0:  # everything tiny: keep the largest
        keep_labels = uniq[np.argmax(counts)][None]
    faces = faces[np.isin(face_label, keep_labels)]
    used = np.unique(faces.reshape(-1))
    remap = np.full(verts.shape[0], -1, np.int64)
    remap[used] = np.arange(used.size)
    return verts[used], remap[faces].astype(np.int32)
