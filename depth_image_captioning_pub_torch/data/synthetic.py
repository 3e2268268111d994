"""Synthetic COCO-format data for tests, smoke runs and rehearsals (the
port's own copy of the JAX package's ``data/synthetic.py``, with Pillow
imported only where a JPEG is written).

``make_synthetic_coco`` writes a deterministic miniature COCO2014-shaped
dataset (JPEGs plus a captions annotation file) that the train and
evaluation CLIs read; the same seed writes the JAX package's files.
``SyntheticCaptions`` holds such a set in memory (uint8 arrays and five
captions an image, the same captions generator), for a machine without
Pillow or a run that should not touch the disk.
"""

from __future__ import annotations

import json
import os
import random
from typing import List, Tuple

import numpy as np

_WORDS = ("a the dog cat man woman red blue small large ball tree park "
          "street sitting standing running holding riding near on in with "
          "two three group plate table water sky grass snow beach bike").split()


def _caption(rng: random.Random) -> str:
    n = rng.randint(4, 9)
    words = [rng.choice(_WORDS) for _ in range(n)]
    return " ".join(words) + rng.choice([".", ""])


def make_synthetic_coco(out_dir: str, num_images: int = 8,
                        image_hw: Tuple[int, int] = (96, 128),
                        captions_per_image: int = 5,
                        seed: int = 0,
                        split: str = "train2014") -> Tuple[str, str]:
    """Write JPEGs + captions JSON; returns (img_dir, ann_file)."""
    from PIL import Image
    rng = random.Random(seed)
    img_dir = os.path.join(out_dir, split)
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    for i in range(num_images):
        image_id = 1000 + i
        file_name = f"COCO_{split}_{image_id:012d}.jpg"
        h, w = image_hw
        arr = np.asarray(
            np.random.default_rng(seed * 10007 + i).integers(0, 256, (h, w, 3)),
            dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(img_dir, file_name), quality=90)
        images.append({"id": image_id, "file_name": file_name,
                       "height": h, "width": w})
        for _ in range(captions_per_image):
            annotations.append({"id": ann_id, "image_id": image_id,
                                "caption": _caption(rng)})
            ann_id += 1
    ann = {"info": {"description": "synthetic fixture"},
           "images": images, "annotations": annotations, "licenses": []}
    ann_file = os.path.join(out_dir, f"captions_{split}.json")
    with open(ann_file, "w") as f:
        json.dump(ann, f)
    return img_dir, ann_file


def synthetic_image_batch(batch_size: int, hw: Tuple[int, int] = (224, 224),
                          seed: int = 0) -> np.ndarray:
    """Deterministic [B,H,W,3] float32 image batch in [0,1] (no disk IO)."""
    rng = np.random.default_rng(seed)
    return rng.random((batch_size, hw[0], hw[1], 3), dtype=np.float32)


class SyntheticCaptions:
    """An in-memory captions dataset: ``num_images`` seeded uint8 images of
    ``image_hw`` and ``captions_per_image`` captions each, with the
    ``load_image`` / ``captions`` / ``len`` interface of
    ``data/coco.CocoCaptions``."""

    def __init__(self, num_images: int, image_hw: Tuple[int, int] = (224, 224),
                 captions_per_image: int = 5, seed: int = 0):
        rng = random.Random(seed)
        self.images = np.random.default_rng(seed).integers(
            0, 256, (num_images, *image_hw, 3), dtype=np.uint8)
        self._caps: List[List[str]] = [
            [_caption(rng) for _ in range(captions_per_image)]
            for _ in range(num_images)]

    def __len__(self) -> int:
        return len(self._caps)

    def load_image(self, index: int) -> np.ndarray:
        return self.images[index]

    def captions(self, index: int) -> List[str]:
        return self._caps[index]


def synthetic_words() -> List[str]:
    """The words the synthetic captions draw from."""
    return list(_WORDS)
