"""ERA5, image and video datasets, the colour transforms, and the
host-side feed (counterpart of ``cra5_tpu/data``)."""

from .era5 import ERA5EvalDataset, ERA5NcDataset, ERA5NpyDataset, resize_bilinear, timestamp_range
from .image import (
    ImageFolder,
    PreGeneratedMemmapDataset,
    RawVideoSequence,
    VideoFolder,
    Vimeo90kDataset,
)
from .prefetch import PrefetchLoader, batch_iterator, device_put
from .transforms import rgb2ycbcr, ycbcr2rgb, yuv_420_to_444, yuv_444_to_420

__all__ = [
    "ERA5EvalDataset",
    "ERA5NpyDataset",
    "ERA5NcDataset",
    "resize_bilinear",
    "timestamp_range",
    "ImageFolder",
    "PreGeneratedMemmapDataset",
    "VideoFolder",
    "RawVideoSequence",
    "Vimeo90kDataset",
    "PrefetchLoader",
    "batch_iterator",
    "device_put",
    "rgb2ycbcr",
    "ycbcr2rgb",
    "yuv_444_to_420",
    "yuv_420_to_444",
]
