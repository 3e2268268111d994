"""Per-word attention overlays of sample mode (counterpart of the JAX
``engine/visualize.py``): caption each image of a ``sample_pic``
directory, then write one PNG per generated word, the 14x14 attention map
upsampled x16, smoothed and blended over the image, and a
``caption.txt``.

``expand_alpha`` is the JAX module's: scipy's bilinear ``zoom`` x16 and a
sigma-8 ``gaussian_filter``. The JAX module renders with matplotlib
(``imshow`` of the image, the heat map at alpha 0.6 in the ``jet``
colormap, the word as the title); this one renders the same blend with
numpy and Pillow alone: a 256-entry ``jet`` table built from matplotlib's
segment data, the heat scaled by its own min and max as ``imshow`` scales
it, an alpha-0.6 blend over the 224x224 image, and the word drawn above it
with ``ImageDraw``'s default font. The files are named as the JAX
module names them: ``<stem>/NN_<word>.png``, ``<stem>/input.png`` and
``caption.txt``.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Dict, List

import numpy as np

from depth_image_captioning_pub_torch.data.tokenizer import SPECIAL

# matplotlib's ``_jet_data``: (x, y0, y1) breakpoints of each channel
JET_SEGMENTS = {
    "red": ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.00, 0.5, 0.5)),
    "green": ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1),
              (0.910, 0, 0), (1.000, 0, 0)),
    "blue": ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.00, 0, 0)),
}
ALPHA = 0.6          # the heat map's opacity over the image
TITLE_PX = 16        # the band above the image that holds the word


def _segment_lut(data, n: int) -> np.ndarray:
    """matplotlib's ``_create_lookup_table(n, data)`` at gamma 1."""
    adata = np.array(data, dtype=np.float64)
    x, y0, y1 = adata[:, 0], adata[:, 1], adata[:, 2]
    xind = np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def jet_table(n: int = 256) -> np.ndarray:
    """[n, 3] RGB in [0, 1]: matplotlib's ``jet`` at ``n`` entries."""
    return np.stack([_segment_lut(JET_SEGMENTS[c], n)
                     for c in ("red", "green", "blue")], axis=1)


def expand_alpha(alpha_14: np.ndarray, upscale: int = 16,
                 sigma: float = 8.0) -> np.ndarray:
    """14x14 attention weights -> smooth 224x224 heat map."""
    from scipy.ndimage import gaussian_filter, zoom
    up = zoom(alpha_14, upscale, order=1)
    return gaussian_filter(up, sigma=sigma)


def heat_rgb(heat: np.ndarray) -> np.ndarray:
    """A heat map -> RGB in [0, 1] through ``jet``, scaled by its own min
    and max (``imshow``'s default ``Normalize``, a constant map at the
    table's first entry) and looked up as a ``Colormap`` call looks up."""
    lut = jet_table()
    lo, hi = float(heat.min()), float(heat.max())
    norm = ((heat - lo) / (hi - lo) if hi > lo
            else np.zeros_like(heat, dtype=np.float64))
    idx = np.clip((norm * len(lut)).astype(np.int64), 0, len(lut) - 1)
    return lut[idx]


def overlay(image_01: np.ndarray, heat: np.ndarray, word: str):
    """A Pillow RGB image: ``image_01`` [H, W, 3] in [0, 1] with ``heat``
    [H, W] blended over it at ``ALPHA``, and ``word`` above it."""
    from PIL import Image, ImageDraw
    h, w = image_01.shape[:2]
    blend = (1.0 - ALPHA) * image_01 + ALPHA * heat_rgb(heat)
    pixels = np.clip(np.rint(blend * 255.0), 0, 255).astype(np.uint8)
    out = Image.new("RGB", (w, h + TITLE_PX), (255, 255, 255))
    out.paste(Image.fromarray(pixels), (0, TITLE_PX))
    ImageDraw.Draw(out).text((2, 2), word, fill=(0, 0, 0))
    return out


def render_attention_overlays(image_01: np.ndarray, words: List[str],
                              alphas: np.ndarray, out_dir: str,
                              grid: int = 14) -> List[str]:
    """Write one overlay PNG per word, ``NN_<word>.png``.

    image_01: [H, W, 3] float in [0, 1]; alphas: [T, grid*grid].
    """
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for t, word in enumerate(words):
        heat = expand_alpha(alphas[t].reshape(grid, grid))
        path = os.path.join(out_dir, f"{t:02d}_{word}.png")
        overlay(image_01, heat, word).save(path)
        paths.append(path)
    return paths


def sample_directory(sample_dir: str, out_dir: str,
                     caption_one: Callable[[np.ndarray], tuple],
                     id_to_word: Dict[int, str],
                     image_size=(224, 224)) -> Dict[str, str]:
    """Caption every *.jpg/*.png under ``sample_dir`` and write the
    overlays and ``caption.txt`` under ``out_dir``.

    ``caption_one(image_01_hw3)`` -> (token_ids [T], alphas [T, K]); the
    image is Pillow's bilinear resize to ``image_size``, as float32 in [0,
    1]. A caption stops at the first ``<end>`` and skips ``<start>``.
    Returns {image_path: caption string}.
    """
    from PIL import Image

    files = sorted(glob.glob(os.path.join(sample_dir, "*.jpg"))
                   + glob.glob(os.path.join(sample_dir, "*.png")))
    captions: Dict[str, str] = {}
    lines = []
    for path in files:
        img = Image.open(path).convert("RGB").resize(image_size[::-1],
                                                     Image.BILINEAR)
        arr = np.asarray(img, dtype=np.float32) / 255.0
        token_ids, alphas = caption_one(arr)
        words, kept = [], []
        for i, tid in enumerate(np.asarray(token_ids).tolist()):
            w = id_to_word[int(tid)]
            if w == SPECIAL.end:
                break
            if w == SPECIAL.start:
                continue
            words.append(w)
            kept.append(np.asarray(alphas)[i])
        caption = " ".join(words)
        captions[path] = caption
        stem = os.path.splitext(os.path.basename(path))[0]
        img_out_dir = os.path.join(out_dir, stem)
        os.makedirs(img_out_dir, exist_ok=True)
        Image.fromarray((arr * 255).astype(np.uint8)).save(
            os.path.join(img_out_dir, "input.png"))
        if kept:
            render_attention_overlays(arr, words, np.stack(kept),
                                      img_out_dir)
        lines.append(f"{os.path.basename(path)}: {caption}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "caption.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return captions
