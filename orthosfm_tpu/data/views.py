"""View metadata and image loading.

Replaces the reference's View class + OpenCV image path
(src/data_structures/view.{h,cpp}, src/util/common.cpp:15-38) with host-side
loading into NumPy arrays. PNG goes through the package's own codec
(io/png.py); TIFF, JPEG and --downscale-factor resizing need Pillow, which
is imported only when one of them is asked for. Images stay on the host;
only feature tensors move to the device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from orthosfm_tpu.io import png

IMAGE_EXTENSIONS = (".tiff", ".tif", ".png", ".jpeg", ".jpg")


def images_in_folder(folder: str) -> List[str]:
    """Sorted list of absolute image paths (reference: common.cpp:15-38 —
    boost directory iteration order is fs-dependent; we sort for determinism)."""
    if not os.path.isdir(folder):
        print("Error: The specified image folder does not exist or is invalid.")
        return []
    out = []
    for entry in sorted(os.listdir(folder)):
        p = os.path.join(folder, entry)
        if os.path.isfile(p) and os.path.splitext(entry)[1].lower() in IMAGE_EXTENSIONS:
            out.append(os.path.abspath(p))
    return out


@dataclasses.dataclass
class View:
    """One input image (reference: view.h:21-66)."""

    view_id: int
    image_path: str
    width: int = 0
    height: int = 0
    pixels: Optional[np.ndarray] = None  # (H, W, 3) uint8 RGB
    mask_path: str = ""
    mask: Optional[np.ndarray] = None  # (H, W) uint8

    @property
    def image_name(self) -> str:
        return os.path.basename(self.image_path)

    @property
    def display_name(self) -> str:
        return f"[View {self.view_id:04d}]"

    def find_corresponding_mask(self, mask_folder: str) -> None:
        """Look for ``{name}_mask.png`` or ``{name}.png``
        (reference: view.cpp:84-98)."""
        stem = os.path.splitext(self.image_name)[0]
        for cand in (f"{stem}_mask.png", f"{stem}.png"):
            p = os.path.join(mask_folder, cand)
            if os.path.isfile(p):
                self.mask_path = p
                return

    def load_pixel_data(self, downscale_factor: int = 1) -> None:
        """Load + bilinear-downscale image (and mask) —
        reference: view.cpp:28-50."""
        img = _read_image(self.image_path, "RGB")
        if downscale_factor != 1:
            h, w = img.shape[:2]
            img = _resize(img, (int(w / downscale_factor), int(h / downscale_factor)))
        self.pixels = img
        self.height, self.width = self.pixels.shape[:2]
        if self.mask_path:
            m = _read_image(self.mask_path, "L")
            if m.shape != (self.height, self.width):
                m = _resize(m, (self.width, self.height))
            self.mask = m

    def is_pixel_masked_in(self, x: float, y: float) -> bool:
        """Mask brightness > 16 means 'keep' (reference: view.cpp:100-112)."""
        if self.mask is None:
            return True
        xi = int(np.clip(x, 0, self.width - 1))
        yi = int(np.clip(y, 0, self.height - 1))
        return int(self.mask[yi, xi]) > 16


def _pillow(why: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"Pillow is needed to {why}; install it (pip install Pillow, or "
            "this package's 'images' extra) or use PNG input at full size"
        ) from e
    return Image


def _read_image(path: str, mode: str) -> np.ndarray:
    """uint8 pixels in ``mode``: "RGB" (H, W, 3) or "L" (H, W). Alpha is
    dropped and gray → RGB replicates, as Pillow's convert() does; RGB → L
    uses Pillow's ITU-R 601-2 luma weights."""
    if os.path.splitext(path)[1].lower() != ".png":
        img = _pillow(f"read {os.path.basename(path)}").open(path)
        return np.asarray(img.convert(mode), np.uint8)
    a = png.read_png(path)
    if a.ndim == 3 and a.shape[2] in (2, 4):
        a = a[..., :-1]  # drop alpha
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    if mode == "RGB":
        return np.repeat(a[..., None], 3, axis=-1) if a.ndim == 2 else a
    if a.ndim == 2:
        return a
    rgb = a.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _resize(img: np.ndarray, size) -> np.ndarray:
    """Bilinear resize to size = (width, height) through Pillow."""
    Image = _pillow("resize images (--downscale-factor)")
    return np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR), np.uint8)


def load_views(image_folder: str, mask_folder: str = "",
               downscale_factor: int = 1) -> List[View]:
    """Load all images in a folder as views (reference: reconstruct.cpp:36-62)."""
    paths = images_in_folder(image_folder)
    views = [View(i, p) for i, p in enumerate(paths)]
    for v in views:
        if mask_folder:
            v.find_corresponding_mask(mask_folder)
        v.load_pixel_data(downscale_factor)
    return views
