"""ImageNet-style directory-tree loading (class-per-folder layout): a copy
of the JAX package's ``fp8tpu/data/imagenet.py`` (NumPy and PIL only), which
gives the same arrays from the same files and draws.

The reference evaluates its 12-model PTQ sweep on torchvision's
``ImageFolder`` + val transforms (Resize(256) -> CenterCrop(224) ->
normalize; examples/inference/classifier/imagenet_test.py:78-99) and
trains with RandomResizedCrop(224) + horizontal flip (ibid:83-88).  This
module gives the same pipeline without torchvision: PIL decode on the
host (imported inside the functions that read images, so nothing else of
the port needs PIL), NumPy transforms, NHWC float32 batches (the scripts
transpose them to NCHW), plus an ``--data_npz`` exporter.

No dataset ships with the repo; point ``root`` at any folder tree

    root/<class_a>/xxx.jpeg
    root/<class_b>/yyy.jpeg

and the loader enumerates classes in sorted order (torchvision's class
indexing rule) so labels line up with torchvision-pretrained heads.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def list_image_folder(root: str) -> Tuple[List[str], List[int], List[str]]:
    """Enumerate an ImageFolder tree → (paths, labels, class_names).
    Classes are the sorted sub-directory names (torchvision's rule)."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f"no class sub-directories under {root!r}")
    paths, labels = [], []
    for idx, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for fn in sorted(os.listdir(cdir)):
            if fn.lower().endswith(_EXTS):
                paths.append(os.path.join(cdir, fn))
                labels.append(idx)
    return paths, labels, classes


def _resize_shorter(img, size: int):
    """torchvision Resize(int): scale so the SHORTER side == size."""
    w, h = img.size
    if w <= h:
        nw, nh = size, max(1, round(h * size / w))
    else:
        nw, nh = max(1, round(w * size / h)), size
    from PIL import Image
    return img.resize((nw, nh), Image.BILINEAR)


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = max((h - size) // 2, 0)
    left = max((w - size) // 2, 0)
    return arr[top:top + size, left:left + size]


def load_image_val(path: str, size: int = 224,
                   resize: int = 256) -> np.ndarray:
    """One image through the reference's VAL transform: Resize(resize) →
    CenterCrop(size) → /255 → normalize.  Returns (size, size, 3) f32."""
    from PIL import Image
    with Image.open(path) as im:
        im = _resize_shorter(im.convert("RGB"), resize)
        arr = np.asarray(im, np.float32) / 255.0
    arr = _center_crop(arr, size)
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def load_image_train(path: str, rng: np.random.Generator,
                     size: int = 224) -> np.ndarray:
    """One image through the TRAIN transform: RandomResizedCrop(size)
    (scale 0.08-1.0, ratio 3/4-4/3 — torchvision defaults) + horizontal
    flip → /255 → normalize."""
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        area = w * h
        for _ in range(10):
            target = area * rng.uniform(0.08, 1.0)
            ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                left = int(rng.integers(0, w - cw + 1))
                top = int(rng.integers(0, h - ch + 1))
                im2 = im.crop((left, top, left + cw, top + ch))
                break
        else:
            # torchvision fallback: resize shorter side then CENTER CROP
            # a square (a bare resize would squash extreme aspect ratios)
            im2 = _resize_shorter(im, size)
            w2, h2 = im2.size
            left = (w2 - size) // 2
            top = (h2 - size) // 2
            im2 = im2.crop((left, top, left + size, top + size))
        im2 = im2.resize((size, size), Image.BILINEAR)
        if rng.random() < 0.5:
            im2 = im2.transpose(Image.FLIP_LEFT_RIGHT)
        arr = np.asarray(im2, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def imagenet_val_batches(root: str, batch_size: int = 64,
                         size: int = 224, resize: int = 256,
                         limit: Optional[int] = None
                         ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (x (B, size, size, 3) f32, y (B,) i32) validation batches —
    the drop-in for the reference's val_loader (imagenet_test.py:94-99).
    NHWC (the JAX layout; the scripts transpose to NCHW); the last short
    batch is yielded as-is."""
    paths, labels, _ = list_image_folder(root)
    if limit is not None:
        paths, labels = paths[:limit], labels[:limit]
    for i in range(0, len(paths), batch_size):
        xs = np.stack([load_image_val(p, size, resize)
                       for p in paths[i:i + batch_size]])
        ys = np.asarray(labels[i:i + batch_size], np.int32)
        yield xs, ys


def imagenet_to_npz(root: str, out: str, limit: Optional[int] = None,
                    size: int = 224, resize: int = 256) -> int:
    """Preprocess a val tree into the ``--data_npz`` format the examples
    consume ({x: (N, H, W, 3) f32 normalized, y: (N,) int}).  Returns N."""
    xs, ys = [], []
    for xb, yb in imagenet_val_batches(root, 64, size, resize, limit):
        xs.append(xb)
        ys.append(yb)
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    np.savez(out, x=x, y=y)
    return int(x.shape[0])
