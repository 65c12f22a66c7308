"""Image and video datasets for the codec zoo.

Counterpart of ``cra5_tpu/data/image.py``, class for class: a
split-directory image folder, pre-extracted uint8 patches on a memmap, a
frame-folder video dataset, a raw planar YUV 4:2:0 reader and the
Vimeo-90k list format. Items are numpy float32 CHW (or TCHW clips) in
[0, 1], read with PIL, as the JAX package's are; ``batch_iterator`` and
``PrefetchLoader`` (``data/prefetch.py``) batch them and move them to the
card.
"""

from __future__ import annotations

import os
import random
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp")


def _read_image(path) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0


def random_crop(img: np.ndarray, size: int, rng: Optional[random.Random] = None) -> np.ndarray:
    rng = rng or random
    _, h, w = img.shape
    if h < size or w < size:
        raise ValueError(f"image {h}x{w} smaller than crop {size}")
    top = rng.randint(0, h - size)
    left = rng.randint(0, w - size)
    return img[:, top : top + size, left : left + size]


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    _, h, w = img.shape
    top = (h - size) // 2
    left = (w - size) // 2
    return img[:, top : top + size, left : left + size]


class ImageFolder:
    """root/{split}/*.png (reference datasets/image.py:40)."""

    def __init__(
        self,
        root: str,
        split: str = "train",
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ):
        splitdir = Path(root) / split
        if not splitdir.is_dir():
            raise RuntimeError(f'Invalid directory "{splitdir}"')
        self.samples = sorted(
            p for p in splitdir.iterdir() if p.suffix.lower() in IMG_EXTENSIONS
        )
        self.transform = transform

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> np.ndarray:
        img = _read_image(self.samples[index])
        return self.transform(img) if self.transform else img


class PreGeneratedMemmapDataset:
    """Memory-mapped pre-extracted uint8 patches, ``root/{training,
    validation}.npy`` holding a flat (N, H, W, 3) array (reference
    datasets/pregenerated.py:44-97). Fast training on pre-shuffled
    patches: rows are read lazily off the memmap and returned as
    float32 CHW in [0, 1] like every other dataset here."""

    def __init__(
        self,
        root: str,
        split: str = "train",
        image_size: int | Sequence[int] = (256, 256),
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ):
        if not Path(root).is_dir():
            raise RuntimeError(f"Invalid path {root}")
        if split == "train":
            filename = "training.npy"
        elif split == "valid":
            filename = "validation.npy"
        else:
            raise ValueError(f"split {split!r} not in ('train', 'valid')")
        if isinstance(image_size, int):
            image_size = (image_size, image_size)
        data = np.memmap(Path(root) / filename, mode="r", dtype="uint8")
        if data.size == 0:
            raise RuntimeError(f"empty memmap {Path(root) / filename}")
        self.data = data.reshape((-1, image_size[0], image_size[1], 3))
        self.transform = transform

    def __len__(self) -> int:
        return self.data.shape[0]

    def __getitem__(self, index: int) -> np.ndarray:
        img = np.asarray(self.data[index], np.float32).transpose(2, 0, 1) / 255.0
        return self.transform(img) if self.transform else img


class VideoFolder:
    """root/{split}/<video>/<frame>.png -> (T, C, H, W) clips of
    ``max_frames`` consecutive frames (reference datasets/video.py)."""

    def __init__(
        self,
        root: str,
        split: str = "train",
        max_frames: int = 3,
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ):
        splitdir = Path(root) / split
        if not splitdir.is_dir():
            raise RuntimeError(f'Invalid directory "{splitdir}"')
        self.clips: List[List[Path]] = []
        for d in sorted(p for p in splitdir.iterdir() if p.is_dir()):
            frames = sorted(f for f in d.iterdir() if f.suffix.lower() in IMG_EXTENSIONS)
            if len(frames) >= max_frames:
                self.clips.append(frames[:max_frames])
        self.transform = transform

    def __len__(self) -> int:
        return len(self.clips)

    def __getitem__(self, index: int) -> np.ndarray:
        frames = [_read_image(p) for p in self.clips[index]]
        clip = np.stack(frames)
        if self.transform:
            clip = np.stack([self.transform(f) for f in clip])
        return clip


class RawVideoSequence:
    """Raw planar YUV420 (.yuv) reader (reference datasets/rawvideo.py):
    frames indexable as dicts of float32 planes in [0, 1]. Geometry is
    parsed from names like ``name_WxH_FPS[_bitdepth].yuv`` or passed
    explicitly."""

    def __init__(
        self,
        path: str,
        width: Optional[int] = None,
        height: Optional[int] = None,
        bitdepth: int = 8,
    ):
        self.path = path
        if width is None or height is None:
            import re

            m = re.search(r"(\d+)x(\d+)", os.path.basename(path))
            if not m:
                raise ValueError(f"cannot parse WxH from {path!r}")
            width, height = int(m.group(1)), int(m.group(2))
        self.width = width
        self.height = height
        self.bitdepth = bitdepth
        self._dtype = np.uint8 if bitdepth == 8 else np.uint16
        bpp = 1 if bitdepth == 8 else 2
        self._frame_bytes = (width * height + 2 * (width // 2) * (height // 2)) * bpp
        self._num_frames = os.path.getsize(path) // self._frame_bytes

    def __len__(self) -> int:
        return self._num_frames

    def __getitem__(self, index: int):
        if not 0 <= index < self._num_frames:
            raise IndexError(index)
        w, h = self.width, self.height
        cw, ch = w // 2, h // 2
        max_val = float(2 ** self.bitdepth - 1)
        with open(self.path, "rb") as f:
            f.seek(index * self._frame_bytes)
            raw = np.frombuffer(f.read(self._frame_bytes), self._dtype)
        y = raw[: w * h].reshape(1, h, w)
        u = raw[w * h : w * h + cw * ch].reshape(1, ch, cw)
        v = raw[w * h + cw * ch :].reshape(1, ch, cw)
        return {
            "y": y.astype(np.float32) / max_val,
            "u": u.astype(np.float32) / max_val,
            "v": v.astype(np.float32) / max_val,
        }


class Vimeo90kDataset:
    """Vimeo-90k septuplets: root/sequences/<a>/<b>/im{1..7}.png with a
    tri_{split}list.txt index (reference datasets/vimeo90k.py)."""

    def __init__(
        self,
        root: str,
        split: str = "train",
        tuplet: int = 3,
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ):
        list_path = Path(root) / f"tri_{split}list.txt"
        if not list_path.is_file():
            raise RuntimeError(f'Missing list file "{list_path}"')
        entries = [l.strip() for l in list_path.read_text().splitlines() if l.strip()]
        self.samples = [
            Path(root) / "sequences" / e / f"im{i}.png"
            for e in entries
            for i in range(1, tuplet + 1)
        ]
        self.transform = transform

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> np.ndarray:
        img = _read_image(self.samples[index])
        return self.transform(img) if self.transform else img
