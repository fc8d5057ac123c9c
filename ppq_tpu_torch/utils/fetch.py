"""Deterministic tensor sampling for loss estimation
(redesign of ppq/utils/fetch.py:1-108 tensor/channel/batch_random_fetch).

Port of ppq_tpu/utils/fetch.py. A tensor may lie on the CPU or on the card:
it is read to the host first, and the same numpy `RandomState(seed)` draws
pick the same indices as the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(tensor) -> np.ndarray:
    if isinstance(tensor, torch.Tensor):
        return tensor.detach().cpu().numpy()
    return np.asarray(tensor)


def tensor_random_fetch(tensor, num_of_fetches: int = 1024,
                        seed: int = 0x20211230) -> np.ndarray:
    """Fetch values uniformly from the flattened tensor."""
    flat = _host(tensor).reshape(-1)
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, flat.size, size=num_of_fetches)
    return flat[idx]


def channel_random_fetch(tensor, fetches_per_channel: int = 1024,
                         channel_axis: int = 0,
                         seed: int = 0x20211230) -> np.ndarray:
    """Per-channel sampling: returns (channels, fetches_per_channel)."""
    arr = _host(tensor)
    moved = np.moveaxis(arr, channel_axis, 0).reshape(arr.shape[channel_axis], -1)
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, moved.shape[1], size=fetches_per_channel)
    return moved[:, idx]


def batch_random_fetch(tensor, fetches_per_batch: int = 1024,
                       seed: int = 0x20211230) -> np.ndarray:
    """Per-batch-element sampling: returns (batch, fetches_per_batch)."""
    arr = _host(tensor)
    flat = arr.reshape(arr.shape[0], -1)
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, flat.shape[1], size=fetches_per_batch)
    return flat[:, idx]
