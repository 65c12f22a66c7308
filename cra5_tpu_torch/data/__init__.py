"""ERA5 datasets and the host-side feed (counterpart of ``cra5_tpu/data``;
the image and video datasets and the colour transforms wait for the model
families that use them, ROADMAP.md queue A5)."""

from .era5 import ERA5EvalDataset, ERA5NcDataset, ERA5NpyDataset, resize_bilinear, timestamp_range
from .prefetch import PrefetchLoader, batch_iterator, device_put

__all__ = [
    "ERA5EvalDataset",
    "ERA5NpyDataset",
    "ERA5NcDataset",
    "resize_bilinear",
    "timestamp_range",
    "PrefetchLoader",
    "batch_iterator",
    "device_put",
]
