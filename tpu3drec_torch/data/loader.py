"""Host-side triplet loader feeding the monodepth trainer (port of
`tpu3drec/data/loader.py`, numpy only: the same seed gives the same
batches, bit for bit).

The reference's `MonoDataset.__getitem__` pipeline (`ref/monodepth2/
mono_dataset.py:128-220`) rebuilt for a device-feeding world: per-sample
(prev, target, next) RGB triplets with shared color-jitter + horizontal
flip augmentation (same params across the triplet, matching
`mono_dataset.py:142-143,181-190`), optional GT depth and GT relative
poses, assembled into NHWC float32 batches. A background prefetch thread
overlaps decode/augment with device compute (the reference runs with
num_workers=0, `options.py:144-147` — decoding serialized with training).
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from tpu3drec_torch.data.datasets import SequenceSpec


def color_jitter_params(rng: np.random.Generator):
    """Monodepth2's ColorJitter ranges (`mono_dataset.py:54-63`):
    brightness/contrast/saturation 0.8-1.2, hue +-0.1."""
    return {
        "brightness": rng.uniform(0.8, 1.2),
        "contrast": rng.uniform(0.8, 1.2),
        "saturation": rng.uniform(0.8, 1.2),
        "hue": rng.uniform(-0.1, 0.1),
    }


def apply_color_jitter(img: np.ndarray, p: dict) -> np.ndarray:
    """img float32 [0,1] HWC."""
    out = img * p["brightness"]
    mean = out.mean(axis=(0, 1), keepdims=True)
    out = (out - mean) * p["contrast"] + mean
    gray = out.mean(axis=2, keepdims=True)
    out = (out - gray) * p["saturation"] + gray
    if abs(p["hue"]) > 1e-6:
        # cheap hue rotation: circular shift mix of channels
        h = p["hue"]
        r, g, b = out[..., 0], out[..., 1], out[..., 2]
        out = np.stack(
            [
                r * (1 - abs(h)) + (g if h > 0 else b) * abs(h),
                g * (1 - abs(h)) + (b if h > 0 else r) * abs(h),
                b * (1 - abs(h)) + (r if h > 0 else g) * abs(h),
            ],
            axis=-1,
        )
    return np.clip(out, 0.0, 1.0)


class TripletLoader:
    """Iterates (prev, target, next) batches from a dataset reader.

    dataset must expose `load_color(folder, idx, size)`; optional
    `gt_relative_pose(folder, idx)` and `load_gt_depth(folder, idx)`.
    """

    def __init__(
        self,
        dataset,
        specs: list[SequenceSpec],
        batch_size: int = 1,
        height: int = 480,
        width: int = 640,
        augment: bool = True,
        with_gt_pose: bool = False,
        with_gt_depth: bool = False,
        with_stereo: bool = False,
        seed: int = 0,
        prefetch: int = 2,
    ):
        self.ds = dataset
        self.specs = specs
        self.batch_size = batch_size
        self.size = (width, height)
        self.augment = augment
        self.with_gt_pose = with_gt_pose
        self.with_gt_depth = with_gt_depth
        # stereo side frame (the reference's "s" frame,
        # `ref/monodepth2/mono_dataset.py:203-209`): dataset must expose
        # load_stereo_color(folder, idx, size) returning the right-camera
        # partner of a left target. batch["stereo_sign"] carries the
        # baseline sign for the constant stereo transform (-1 normally:
        # a point in right-cam coords is X_left - [B,0,0]; +1 when the
        # horizontal flip mirrors the geometry, matching the reference's
        # baseline_sign flip).
        self.with_stereo = with_stereo
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.skipped = 0  # unreadable samples dropped (resilience counter)

    def __len__(self):
        return len(self.specs) // self.batch_size

    def _load_sample(self, spec: SequenceSpec):
        imgs = {}
        for off, key in ((-1, "prev"), (0, "target"), (1, "next")):
            img = self.ds.load_color(spec.folder, spec.frame_index + off, size=self.size)
            imgs[key] = np.asarray(img, np.float32) / 255.0
        if self.with_stereo:
            img = self.ds.load_stereo_color(spec.folder, spec.frame_index,
                                            size=self.size)
            imgs["stereo"] = np.asarray(img, np.float32) / 255.0
        flip = self.augment and self.rng.random() > 0.5
        jitter = self.augment and self.rng.random() > 0.5
        if jitter:
            p = color_jitter_params(self.rng)
            imgs = {k: apply_color_jitter(v, p) for k, v in imgs.items()}
        if flip:
            imgs = {k: v[:, ::-1].copy() for k, v in imgs.items()}
        sample = dict(imgs)
        if self.with_stereo:
            # baseline_sign flip of `mono_dataset.py:203-209` (left target):
            # T_stereo[0,3] = stereo_sign * baseline
            sample["stereo_sign"] = np.float32(1.0 if flip else -1.0)
        if self.with_gt_pose:
            aa, t = self.ds.gt_relative_pose(spec.folder, spec.frame_index)
            sample["gt_axisangle"] = aa
            sample["gt_translation"] = t
        if self.with_gt_depth:
            d = self.ds.load_gt_depth(spec.folder, spec.frame_index)
            if flip:
                d = d[:, ::-1].copy()
            sample["gt_depth"] = d.astype(np.float32)
        return sample

    def _batches(self, order):
        """Assemble batches, skipping unreadable samples (corrupt files,
        missing neighbors) instead of killing the epoch — the failure-
        tolerance the reference lacks (a bad PNG aborts its DataLoader)."""
        B = self.batch_size
        samples = []
        for j in order:
            try:
                samples.append(self._load_sample(self.specs[j]))
            except (OSError, ValueError, IndexError, KeyError) as e:
                self.skipped += 1
                if self.skipped <= 10:
                    import sys

                    print(f"[loader] skipping sample {self.specs[j]}: {e}",
                          file=sys.stderr)
                continue
            if len(samples) == B:
                yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}
                samples = []

    def __iter__(self):
        order = self.rng.permutation(len(self.specs))
        if self.prefetch <= 0:
            yield from self._batches(order)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        DONE = object()

        def worker():
            try:
                for b in self._batches(order):
                    q.put(b)
            except Exception as e:  # raised again in the consuming thread
                q.put(e)
            finally:
                q.put(DONE)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        while True:
            b = q.get()
            if b is DONE:
                break
            if isinstance(b, Exception):
                raise b
            yield b
