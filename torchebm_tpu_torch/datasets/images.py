r"""Image datasets for conv-energy training (counterpart of
:mod:`torchebm_tpu.datasets.images`).

``load_mnist`` reads MNIST idx files from disk (``MNIST_PATH`` or the same
cache locations as the JAX package); without them it falls back to
sklearn's bundled 8×8 digits, bilinearly upsampled to 28×28, with the same
shape and scale as MNIST: float32 ``(N, 1, 28, 28)`` in ``[-1, 1]`` and
int64 labels ``(N,)``. sklearn is imported only on that fallback.
"""

from __future__ import annotations

import gzip
import os
import struct as _struct
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.module import default_device

Tensor = torch.Tensor

__all__ = ["load_mnist"]

_MNIST_CANDIDATES = (
    os.environ.get("MNIST_PATH", ""),
    os.path.expanduser("~/.cache/mnist"),
    "/data/mnist",
    "/tmp/mnist",
)


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = _struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = _struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _try_local_mnist(split: str):
    prefix = "train" if split == "train" else "t10k"
    for root in _MNIST_CANDIDATES:
        if not root or not os.path.isdir(root):
            continue
        for ext in ("", ".gz"):
            img = os.path.join(root, f"{prefix}-images-idx3-ubyte{ext}")
            lbl = os.path.join(root, f"{prefix}-labels-idx1-ubyte{ext}")
            if os.path.exists(img) and os.path.exists(lbl):
                return _read_idx(img).astype(np.float32), _read_idx(lbl).astype(np.int64)
    return None


def _digits_fallback(split: str):
    """sklearn's bundled 8×8 digits, upsampled to 28×28."""
    from sklearn.datasets import load_digits

    digits = load_digits()
    images = digits.images.astype(np.float32) / 16.0 * 255.0  # (N, 8, 8)
    labels = digits.target.astype(np.int64)
    # deterministic split: the last 297 samples are "test"
    if split == "train":
        images, labels = images[:1500], labels[:1500]
    else:
        images, labels = images[1500:], labels[1500:]
    # half-pixel bilinear upsampling clamped at the border: for upsampling
    # this is jax.image.resize's "bilinear", which renormalises its triangle
    # weights over the pixels inside the image
    x = F.interpolate(torch.from_numpy(images)[:, None], size=(28, 28), mode="bilinear",
                      align_corners=False)
    return x.numpy(), labels


def load_mnist(split: str = "train", flatten: bool = False,
               device: Optional[torch.device] = None) -> Tuple[Tensor, Tensor]:
    """Return ``(images, labels)`` on ``device`` (by default the current CUDA
    device when there is one, else the CPU): float32 images in [-1, 1], NCHW
    ``(N, 1, 28, 28)`` (``(N, 784)`` with ``flatten=True``), and int64 labels.
    Real MNIST when idx files are found, the digits fallback otherwise."""
    if split not in ("train", "test"):
        raise ValueError(f"split must be 'train' or 'test', got {split!r}")
    device = default_device() if device is None else torch.device(device)
    local = _try_local_mnist(split)
    if local is not None:
        images, labels = local
        images = images[:, None, :, :]
    else:
        images, labels = _digits_fallback(split)
    x = torch.as_tensor(images, dtype=torch.float32, device=device) / 127.5 - 1.0
    if flatten:
        x = x.reshape(x.shape[0], -1)
    return x, torch.as_tensor(labels, device=device)
