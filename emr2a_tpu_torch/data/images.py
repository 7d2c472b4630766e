"""Host-side image decode and resize feeding the device pipeline.

The port's own copy of ``emr2a_tpu/data/images.py`` (the JAX package's
helpers load no JAX, but the port keeps its own modules): decode to uint8
RGB with cv2 first and PIL as the fallback, failures mapped to None; the
shortest-edge resize plan shared with ``ops/preprocess.py``; the host
resize that canonicalises mixed-size batches; grouping by shape.
``tests/test_torch_data.py`` holds the two copies equal.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


def load_image_rgb(path) -> Optional[np.ndarray]:
    """Decode one image to (H, W, 3) uint8 RGB; None on failure.
    cv2 (C++) first for speed, PIL as the fallback for formats cv2's
    build can't handle."""
    if _HAS_CV2:
        try:
            arr = cv2.imread(str(path), cv2.IMREAD_COLOR)
            if arr is not None:
                return cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
        except Exception:
            pass
    try:
        from PIL import Image
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"))
    except Exception:
        return None


def load_images_rgb(paths: Sequence) -> List[Optional[np.ndarray]]:
    return [load_image_rgb(p) for p in paths]


def plan_resize(h: int, w: int, size: int,
                shortest_edge: bool = True) -> tuple:
    """Target (nh, nw): shortest edge scaled to ``size`` (both >= size)
    or an exact square."""
    if not shortest_edge:
        return size, size
    scale = size / min(h, w)
    return max(size, round(h * scale)), max(size, round(w * scale))


def resize_to(arr: np.ndarray, size: int, shortest_edge: bool = True,
              method: str = "bicubic") -> np.ndarray:
    """Host resize (cv2/PIL) used to canonicalize mixed-size batches
    before the device pipeline; geometry matches ops/preprocess."""
    h, w = arr.shape[:2]
    # the ONE geometry shared with the device pipeline: jit_encoder
    # canonicalizes here, then ops/preprocess re-plans and must land on
    # the same (nh, nw) to skip its device resample
    nh, nw = plan_resize(h, w, size, shortest_edge)
    if (nh, nw) == (h, w):
        return arr
    if _HAS_CV2:
        interp = cv2.INTER_CUBIC if method == "bicubic" else cv2.INTER_LINEAR
        if nh < h:  # downsample: area resampling ~ antialiased
            interp = cv2.INTER_AREA
        return cv2.resize(arr, (nw, nh), interpolation=interp)
    from PIL import Image
    resample = Image.BICUBIC if method == "bicubic" else Image.BILINEAR
    return np.asarray(Image.fromarray(arr).resize((nw, nh), resample))


def group_by_shape(images: List[Optional[np.ndarray]]
                   ) -> Dict[Tuple[int, int], List[int]]:
    """Indices of non-None images grouped by (H, W) so each group forms
    one static-shape device batch."""
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, img in enumerate(images):
        if img is None:
            continue
        groups.setdefault(img.shape[:2], []).append(i)
    return groups
