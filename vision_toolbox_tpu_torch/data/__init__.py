from .datasets import ImageFolder, Sample, iter_webdataset, process_rank, shard_for_host  # noqa: F401
from .loader import DataLoader, DeviceFeed, prefetch_to_device  # noqa: F401
from .transforms import (  # noqa: F401
    center_crop,
    random_resized_crop,
    resize_short_side,
    to_float_array,
    train_transform,
    val_transform,
)
