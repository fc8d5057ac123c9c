"""Calibration/eval data IO: a prefetching .npy batch loader
(ppq_tpu/utils/dataio.py).

The native backend (the repository's csrc/dataloader.cc, built and bound by
utils/native.py) reads and decodes npy files on a worker-thread pool,
keeping a bounded ring of batches ahead of the consumer, so a calibration
sweep does not wait on file IO. Where the toolchain is unavailable it falls
back to plain np.load; both paths yield bit-identical arrays in submit order.
The arrays are host numpy: the executor uploads each batch to the card.

NpyLoader is RE-ITERABLE: every __iter__ opens a fresh native session
(quantize_graph peeks one batch for shape inference and then iterates the
loader again; both passes must see batch 0 first).

Usage:
    for batch in NpyLoader(sorted(glob('data/*.npy')), prefetch=8):
        executor.forward(batch)
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterable, Iterator, List, Sequence

import numpy as np

_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64,
           4: np.uint8, 5: np.int8, 6: np.float16, 7: np.bool_}
_STATUS = {1: 'open failed', 2: 'bad npy magic', 3: 'bad npy header',
           4: 'unsupported dtype', 5: 'short read'}
_MAX_NDIM = 16     # dl_next_meta's shape_out capacity (dataloader.cc)


class NpyLoader:
    """Iterate npy files as numpy arrays, prefetched off-thread by the
    native loader (`native=False`, or a failed build: `np.load` in turn)."""

    def __init__(self, paths: Sequence[str], prefetch: int = 4,
                 threads: int = 2, native: bool = True):
        self.paths: List[str] = [os.fspath(p) for p in paths]
        self.prefetch = max(1, prefetch)
        self.threads = max(1, threads)
        self._nd = None
        if native and self.paths:
            from .native import native_dataio
            self._nd = native_dataio()       # None -> np.load fallback

    @property
    def native(self) -> bool:
        """Whether the native prefetcher reads the files."""
        return self._nd is not None

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[np.ndarray]:
        if self._nd is None:
            for p in self.paths:
                yield np.load(p)
            return
        # fresh session per iteration: the loader stays re-iterable
        lib = self._nd._lib
        h = int(lib.dl_create(self.prefetch, self.threads))
        if h == 0:
            for p in self.paths:
                yield np.load(p)
            return
        try:
            for p in self.paths:
                lib.dl_submit(h, p.encode())
            i64, i32 = ctypes.c_int64, ctypes.c_int32
            for p in self.paths:
                shape = (i64 * _MAX_NDIM)()
                ndim, dtype, fortran = i32(), i32(), i32()
                nbytes = i64()
                rc = lib.dl_next_meta(h, shape, ctypes.byref(ndim),
                                      ctypes.byref(dtype),
                                      ctypes.byref(fortran),
                                      ctypes.byref(nbytes))
                if rc != 0:
                    lib.dl_next_copy(h, None)      # drop the bad item
                    raise IOError(f'{p}: '
                                  f'{_STATUS.get(rc, f"error {rc}")}')
                if ndim.value > _MAX_NDIM:
                    raise IOError(f'{p}: {ndim.value}-d array exceeds the '
                                  f'native loader limit ({_MAX_NDIM}); '
                                  f'use np.load')
                shp = tuple(shape[i] for i in range(ndim.value))
                arr = np.empty(int(nbytes.value), np.uint8)
                rc = lib.dl_next_copy(
                    h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
                if rc != 0:
                    raise IOError(f'{p}: '
                                  f'{_STATUS.get(rc, f"error {rc}")}')
                out = arr.view(_DTYPES[dtype.value])
                order = 'F' if fortran.value else 'C'
                yield out.reshape(shp, order=order)
        finally:
            lib.dl_close(h)


def load_calibration_dir(data_dir: str, limit: int = None,
                         prefetch: int = 4) -> Iterable[np.ndarray]:
    """All .npy batches under data_dir, sorted, prefetched."""
    files = sorted(f for f in os.listdir(data_dir) if f.endswith('.npy'))
    if limit is not None:
        files = files[:limit]
    return NpyLoader([os.path.join(data_dir, f) for f in files],
                     prefetch=prefetch)
