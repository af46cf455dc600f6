"""Image data on disk for the port's tests, written from a seed in the
formats the loaders read: the CIFAR-10 pickles and image folders (PIL
JPEGs, with damaged files among them). Not a test module."""

from __future__ import annotations

import os
import pickle

import numpy as np


def write_cifar_pickles(root: str, per_batch: int, n_test: int,
                        seed: int = 0) -> str:
    """``root/cifar-10-batches-py/data_batch_1..5`` of ``per_batch``
    images each and ``test_batch`` of ``n_test``: the CIFAR-10 python
    layout (``b"data"`` uint8 ``[n, 3072]`` channel-major, ``b"labels"``
    a list of ints). Returns ``root``."""
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name in names:
        n = n_test if name == "test_batch" else per_batch
        d = {b"data": rng.integers(0, 256, (n, 3072), np.uint8),
             b"labels": [int(x) for x in rng.integers(0, 10, n)],
             b"batch_label": name.encode()}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(d, f, protocol=2)
    return root


def write_image_folder(root: str, classes: int, per_class: int, *,
                       seed: int = 0, size=(40, 30), bad=()) -> list:
    """``root/c<k>/img<i>.jpg`` JPEGs of seeded noise (sizes vary around
    ``size``), PNGs for every third; ``bad`` names ``(class, i, kind)``
    files to damage: ``"truncated"`` (a JPEG cut in half) or ``"empty"``
    (zero bytes). Returns the damaged paths."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    damaged = []
    kinds = {(c, i): k for c, i, k in bad}
    for c in range(classes):
        cdir = os.path.join(root, f"c{c}")
        os.makedirs(cdir, exist_ok=True)
        for i in range(per_class):
            w = size[0] + int(rng.integers(-8, 9))
            h = size[1] + int(rng.integers(-8, 9))
            px = rng.integers(0, 256, (h, w, 3), np.uint8)
            ext = "png" if i % 3 == 2 else "jpg"
            path = os.path.join(cdir, f"img{i:03d}.{ext}")
            Image.fromarray(px).save(path, quality=90)
            kind = kinds.get((c, i))
            if kind == "truncated":
                data = open(path, "rb").read()
                with open(path, "wb") as f:
                    f.write(data[:len(data) // 2])
            elif kind == "empty":
                open(path, "wb").close()
            if kind:
                damaged.append(path)
    return damaged
