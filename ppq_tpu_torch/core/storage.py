"""Native checkpoint serialization (reference: ppq/core/storage.py:28-108).

The `.native` format is the framework's full-state checkpoint: the whole
BaseGraph — ops, variables, parameter values, TQCs including their sharing
links — written to one file and restored bit-exact. Implementation here is a
versioned pickle with tensors packed as raw numpy buffers (fast + compact),
not pickled ndarray objects.
"""

from __future__ import annotations

import io
import pickle
from typing import Any

import numpy as np

NATIVE_MAGIC = b'PPQTPU01'
FORMAT_VERSION = 1


class ValueState:
    """Pack/unpack a tensor as (dtype, shape, raw bytes)."""

    __slots__ = ('dtype', 'shape', 'raw')

    def __init__(self, array: np.ndarray):
        array = np.ascontiguousarray(array)
        self.dtype = array.dtype.str
        self.shape = array.shape
        self.raw = array.tobytes()

    def unpack(self) -> np.ndarray:
        return np.frombuffer(self.raw, dtype=np.dtype(self.dtype)).reshape(self.shape).copy()


class _TensorPackingPickler(pickle.Pickler):
    def persistent_id(self, obj):
        return None


def dump_native(obj: Any, path: str) -> None:
    with open(path, 'wb') as f:
        f.write(NATIVE_MAGIC)
        f.write(FORMAT_VERSION.to_bytes(4, 'little'))
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_native(path: str) -> Any:
    with open(path, 'rb') as f:
        magic = f.read(len(NATIVE_MAGIC))
        if magic != NATIVE_MAGIC:
            raise ValueError(
                f'{path} is not a ppq_tpu native checkpoint (bad magic {magic!r})')
        version = int.from_bytes(f.read(4), 'little')
        if version > FORMAT_VERSION:
            raise ValueError(
                f'Checkpoint version {version} is newer than this build '
                f'({FORMAT_VERSION}); upgrade ppq_tpu.')
        return pickle.load(f)


def dumps_native(obj: Any) -> bytes:
    buf = io.BytesIO()
    buf.write(NATIVE_MAGIC)
    buf.write(FORMAT_VERSION.to_bytes(4, 'little'))
    pickle.dump(obj, buf, protocol=pickle.HIGHEST_PROTOCOL)
    return buf.getvalue()


def loads_native(data: bytes) -> Any:
    buf = io.BytesIO(data)
    magic = buf.read(len(NATIVE_MAGIC))
    if magic != NATIVE_MAGIC:
        raise ValueError('not a ppq_tpu native checkpoint')
    int.from_bytes(buf.read(4), 'little')
    return pickle.load(buf)
