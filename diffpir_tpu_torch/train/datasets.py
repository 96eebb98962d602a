"""Training image pipeline: sharded, infinite, class-conditional loader.

Port of ``diffpir_tpu/train/datasets.py`` (reference
``guided_diffusion/image_datasets.py``): recursive file listing, sharding
(``shard=rank, num_shards=world``), class labels from the filename prefix
before the first "_", progressive BOX halving then a BICUBIC resize of the
short side, centre or random crop, optional flip, and an infinite shuffled
order from ``random.Random``, batched drop-last into NHWC float32 in
[-1, 1].  Images are read with ``utils/image.py::imread_uint`` (JPEG, PNG,
GIF and the other formats of ``utils/imageio.py``, as Pillow reads them) and
resized with ``utils/resample.py`` (Pillow's algorithm in numpy).  Without
explicit ``shard``/``num_shards`` the shard is this process's rank in an
initialised ``torch.distributed`` group, else the only one.
"""

from __future__ import annotations

import os
import random
from typing import Iterator, Optional, Sequence

import numpy as np

from diffpir_tpu_torch.utils import resample
from diffpir_tpu_torch.utils.image import imread_uint

__all__ = ["list_image_files_recursively", "ImageDataset", "load_data"]


def list_image_files_recursively(data_dir: str) -> list[str]:
    out = []
    for entry in sorted(os.listdir(data_dir)):
        full = os.path.join(data_dir, entry)
        ext = entry.split(".")[-1].lower()
        if "." in entry and ext in ("jpg", "jpeg", "png", "gif"):
            out.append(full)
        elif os.path.isdir(full):
            out.extend(list_image_files_recursively(full))
    return out


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return arr[top:top + size, left:left + size]


def _random_crop(arr: np.ndarray, size: int, rng: random.Random) -> np.ndarray:
    h, w = arr.shape[:2]
    top = rng.randrange(h - size + 1)
    left = rng.randrange(w - size + 1)
    return arr[top:top + size, left:left + size]


class ImageDataset:
    """Sharded image dataset over local PNG files."""

    def __init__(self, resolution: int, image_paths: Sequence[str],
                 classes: Optional[Sequence[int]] = None, shard: int = 0,
                 num_shards: int = 1, random_crop: bool = False,
                 random_flip: bool = True, seed: int = 0):
        self.resolution = resolution
        self.paths = list(image_paths)[shard::num_shards]
        self.classes = (None if classes is None
                        else list(classes)[shard::num_shards])
        self.random_crop = random_crop
        self.random_flip = random_flip
        self.rng = random.Random(seed + shard)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int):
        arr = imread_uint(self.paths[idx], 3)
        # halve while the short side is at least twice the resolution, then
        # scale the short side to it (reference image_datasets.py:131-141)
        while min(arr.shape[:2]) >= 2 * self.resolution:
            h, w = arr.shape[:2]
            arr = resample.resize(arr, (w // 2, h // 2), resample.BOX)
        h, w = arr.shape[:2]
        scale = self.resolution / min(h, w)
        arr = resample.resize(arr, (round(w * scale), round(h * scale)),
                              resample.BICUBIC)
        arr = (_random_crop(arr, self.resolution, self.rng) if self.random_crop
               else _center_crop(arr, self.resolution))
        if self.random_flip and self.rng.random() < 0.5:
            arr = arr[:, ::-1]
        arr = arr.astype(np.float32) / 127.5 - 1.0
        label = None if self.classes is None else self.classes[idx]
        return arr, label


def _default_shard() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def load_data(*, data_dir: str, batch_size: int, image_size: int,
              class_cond: bool = False, deterministic: bool = False,
              random_crop: bool = False, random_flip: bool = True,
              shard: Optional[int] = None, num_shards: Optional[int] = None,
              seed: int = 0) -> Iterator[tuple[np.ndarray, Optional[np.ndarray]]]:
    """Infinite iterator of (images (B,H,W,3) in [-1,1], labels or None)."""
    if shard is None or num_shards is None:
        shard, num_shards = _default_shard()

    files = list_image_files_recursively(data_dir)
    classes = None
    if class_cond:
        names = [os.path.basename(p).split("_")[0] for p in files]
        sorted_classes = {c: i for i, c in enumerate(sorted(set(names)))}
        classes = [sorted_classes[n] for n in names]

    ds = ImageDataset(image_size, files, classes, shard=shard,
                      num_shards=num_shards, random_crop=random_crop,
                      random_flip=random_flip, seed=seed)
    if len(ds) < batch_size:
        # drop-last batching would otherwise yield nothing, forever
        raise ValueError(
            f"shard {shard}/{num_shards} has {len(ds)} images < batch_size "
            f"{batch_size} (under {data_dir!r})")
    order_rng = random.Random(seed * 7919 + shard)
    order = list(range(len(ds)))
    while True:
        if not deterministic:
            order_rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            imgs, labels = zip(*(ds[j] for j in order[i:i + batch_size]))
            yield (np.stack(imgs),
                   None if classes is None else np.asarray(labels, np.int64))
