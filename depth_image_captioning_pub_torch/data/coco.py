"""COCO-captions dataset reader (the port's own copy of the JAX package's
``data/coco.py``).

Index order matches torchvision's ``CocoCaptions``: items are enumerated
over image ids sorted ascending, and each item's caption list keeps the
annotation file's order, so the frozen eval-subset index files
(``data_index/np_val_index.npy``) point at the same images. Pillow decodes
``load_image``'s JPEGs; it is imported when an image is first read, so the
package imports (and captions uint8 arrays) where Pillow is missing.
``load_images_batch`` decodes through ``data/native_loader.py``, as the JAX
package's does.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class CocoCaptions:
    """Minimal (image, captions) dataset over a COCO annotation file."""

    def __init__(self, root: str, ann_file: str,
                 image_size: Optional[Tuple[int, int]] = (224, 224)):
        self.root = root
        self.image_size = image_size
        with open(ann_file) as f:
            data = json.load(f)
        file_names: Dict[int, str] = {
            img["id"]: img["file_name"] for img in data["images"]}
        caps: Dict[int, List[str]] = {}
        for ann in data["annotations"]:  # file order == pycocotools imgToAnns order
            caps.setdefault(ann["image_id"], []).append(ann["caption"])
        # torchvision iterates sorted(self.coco.imgs.keys())
        self.ids: List[int] = sorted(file_names.keys())
        self._file_names = file_names
        self._caps = caps

    def __len__(self) -> int:
        return len(self.ids)

    def image_path(self, index: int) -> str:
        return os.path.join(self.root, self._file_names[self.ids[index]])

    def captions(self, index: int) -> List[str]:
        return self._caps.get(self.ids[index], [])

    def load_image(self, index: int) -> np.ndarray:
        """Decode + bilinear-resize one image -> uint8 HWC (the /255 and
        the normalization happen on the device)."""
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("reading COCO JPEGs needs Pillow, which is not "
                              "installed; caption uint8 arrays instead "
                              "(CaptionPipeline)") from e
        img = Image.open(self.image_path(index)).convert("RGB")
        if self.image_size is not None:
            img = img.resize(self.image_size[::-1], Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)

    def load_images_batch(self, indices) -> np.ndarray:
        """Batched decode via the native loader (threaded libjpeg with
        DCT-domain scaling; per-file fallback to ``image_io``) -> [N, H, W,
        3] uint8, the JAX package's bytes."""
        from depth_image_captioning_pub_torch.data.native_loader import (
            available, decode_batch)
        if self.image_size is None or not available():
            return np.stack([self.load_image(i) for i in indices])
        return decode_batch([self.image_path(i) for i in indices],
                            self.image_size)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, List[str]]:
        return self.load_image(index), self.captions(index)


class Subset:
    """Fixed-index subset (the eval subsets of ``data_index/``)."""

    def __init__(self, dataset: CocoCaptions, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[self.indices[i]]

    def captions(self, i: int) -> List[str]:
        return self.dataset.captions(self.indices[i])

    def load_image(self, i: int) -> np.ndarray:
        return self.dataset.load_image(self.indices[i])


def load_index_file(path: str) -> List[int]:
    """Load a frozen eval-subset .npy index array (data_index/*.npy)."""
    return np.load(path).tolist()
