"""Depth decoding, one named mode per dataset (port of `tpu3drec/utils/depthio.py`).

Host-side by design: the result feeds the device in one batch transfer.
PIL is imported only inside the functions that decode an image, so the
port imports on a machine without it.
"""

from __future__ import annotations

import numpy as np

DEPTH_MODES = (
    "gray8",        # 8-bit grayscale; pixel value IS metric depth (reference RGBD path)
    "green8",       # green channel of an RGB read
    "uint16",       # 16-bit PNG, raw counts
    "uint16_mm",    # 16-bit PNG in millimetres -> metres
    "npy",          # .npy float array
    "float",        # float image via PIL 'F' mode
)


def load_depth(
    path: str,
    mode: str = "gray8",
    scale: float = 1.0,
    size: tuple[int, int] | None = None,  # (width, height)
) -> np.ndarray:
    """Load one depth map as float32 (H, W), optionally NEAREST-resized.
    ``scale`` multiplies decoded values (e.g. 1/1000 for mm->m)."""
    if mode not in DEPTH_MODES:
        raise ValueError(f"unknown depth mode {mode!r}; one of {DEPTH_MODES}")

    if mode == "npy":
        depth = np.load(path).astype(np.float32)
        if size is not None and depth.shape[::-1] != size:
            depth = _resize_nearest(depth, size)
        return depth * scale

    from PIL import Image

    img = Image.open(path)
    if mode == "gray8":
        img = img.convert("L")
    elif mode == "green8":
        img = img.convert("RGB")
    elif mode in ("uint16", "uint16_mm"):
        if img.mode not in ("I", "I;16", "I;16B"):
            img = img.convert("I")
    elif mode == "float":
        img = img.convert("F")
    if size is not None:
        img = img.resize(size, Image.NEAREST)
    arr = np.asarray(img)
    if mode == "green8":
        arr = arr[..., 1]
    depth = arr.astype(np.float32)
    if mode == "uint16_mm":
        depth = depth / 1000.0
    return depth * scale


def _resize_nearest(arr: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize: source index floor(dst * src / dst_size)."""
    w, h = size
    ys = (np.arange(h) * arr.shape[0] / h).astype(np.int64)
    xs = (np.arange(w) * arr.shape[1] / w).astype(np.int64)
    return arr[ys][:, xs]


def load_depth_stack(
    paths: list[str], mode: str = "gray8", scale: float = 1.0,
    size: tuple[int, int] | None = None,
) -> np.ndarray:
    """Load a sequence into one (F, H, W) float32 stack."""
    maps = [load_depth(p, mode=mode, scale=scale, size=size) for p in paths]
    return np.stack(maps, axis=0)


def load_image_rgb(path: str, size: tuple[int, int] | None = None) -> np.ndarray:
    """RGB image as uint8 (H, W, 3)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize(size, Image.BILINEAR)
    return np.asarray(img)
