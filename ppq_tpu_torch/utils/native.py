"""Native host libraries: built at first use, bound with ctypes.

Counterpart of ppq_tpu/utils/native.py. Three C++ libraries with a plain
extern "C" interface, each compiled with `g++ -O3 -shared -fPIC -std=c++17`
into `ppq_tpu_torch/csrc/build/` (listed in `.gitignore`) the first time
something asks for it, never at import:

  * the solvers: `ppq_tpu_torch/csrc/solvers.cc`, a copy of the
    repository's `csrc/solvers.cc` (KL and MSE clip searches, isotonic
    regression, the histogram MSE loss);
  * the paged-KV block allocator: the repository's `csrc/allocator.cc`,
    built as it is (`NativeAllocLib`, used by `serving/paged.py`);
  * the prefetching npy loader: the repository's `csrc/dataloader.cc`,
    built as it is with `-pthread` (`NativeDataLib`, used by
    `utils/dataio.py`).

Where a build fails, a warning is logged and the callers take their Python
twins (numpy searches, the Python free list, `np.load`), as the JAX package
does. None of these is a card kernel: they run on the host.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..core import ppq_warning

_lock = threading.Lock()
_lib_cache: Optional['NativeSolvers'] = None
_build_failed = False

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PACKAGE, 'csrc', 'solvers.cc')
_BUILD_DIR = os.path.join(os.path.dirname(_SRC), 'build')
_SO = os.path.join(_BUILD_DIR, 'libppq_tpu_torch_solvers.so')
# the repository's own host sources, built unedited
_REPO_CSRC = os.path.join(os.path.dirname(_PACKAGE), 'csrc')


def _build_library(src: str, so: str, extra=()) -> str:
    """Compile `src` into `so` unless it is newer than its source. The output
    is written under a name of this process and renamed into place, so that
    processes building at once never load a half-written file."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    tmp = f'{so}.{os.getpid()}.tmp'
    cmd = ['g++', '-O3', '-shared', '-fPIC', '-std=c++17', *extra, src,
           '-o', tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so)
    return so


def _build() -> str:
    return _build_library(_SRC, _SO)


class NativeSolvers:
    def __init__(self, path: str):
        lib = ctypes.CDLL(path)
        lib.kl_search.restype = ctypes.c_int
        lib.kl_search.argtypes = [ctypes.POINTER(ctypes.c_double),
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.mse_search.restype = ctypes.c_int
        lib.mse_search.argtypes = [ctypes.POINTER(ctypes.c_double),
                                   ctypes.c_int, ctypes.c_double,
                                   ctypes.c_int, ctypes.c_int]
        lib.isotone_solve.restype = None
        lib.isotone_solve.argtypes = [ctypes.POINTER(ctypes.c_double),
                                      ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_double)]
        lib.compute_mse_loss.restype = ctypes.c_double
        lib.compute_mse_loss.argtypes = [ctypes.POINTER(ctypes.c_double),
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int]
        self._lib = lib

    @staticmethod
    def _ptr(arr: np.ndarray):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    def kl_search(self, hist: np.ndarray, levels: int, interval: int) -> int:
        hist = np.ascontiguousarray(hist, np.float64)
        return self._lib.kl_search(self._ptr(hist), len(hist),
                                   levels, interval)

    def mse_search(self, hist: np.ndarray, hist_scale: float, levels: int,
                   interval: int) -> int:
        hist = np.ascontiguousarray(hist, np.float64)
        return self._lib.mse_search(self._ptr(hist), len(hist),
                                    float(hist_scale), levels, interval)

    def isotone(self, values: np.ndarray) -> np.ndarray:
        values = np.ascontiguousarray(values, np.float64)
        out = np.empty_like(values)
        self._lib.isotone_solve(self._ptr(values), len(values),
                                self._ptr(out))
        return out

    def compute_mse_loss(self, hist: np.ndarray, start: int, step: int,
                         end: int) -> float:
        hist = np.ascontiguousarray(hist, np.float64)
        return self._lib.compute_mse_loss(self._ptr(hist), len(hist),
                                          start, step, end)


def native_solvers() -> Optional[NativeSolvers]:
    """Build-once, cached loader. Returns None when the toolchain is
    unavailable (callers fall back to numpy)."""
    global _lib_cache, _build_failed
    if _lib_cache is not None:
        return _lib_cache
    if _build_failed:
        return None
    with _lock:
        if _lib_cache is not None:
            return _lib_cache
        try:
            _lib_cache = NativeSolvers(_build())
        except (OSError, subprocess.CalledProcessError) as e:
            _build_failed = True
            ppq_warning(f'native solver build failed ({e}); '
                        f'falling back to numpy solvers.')
            return None
    return _lib_cache


# ------------------------------------------------- paged-KV allocator ------

_ALLOC_SRC = os.path.join(_REPO_CSRC, 'allocator.cc')
_ALLOC_SO = os.path.join(_BUILD_DIR, 'libppq_tpu_torch_alloc.so')
_alloc_cache: Optional['NativeAllocLib'] = None
_alloc_failed = False


class NativeAllocLib:
    """ctypes surface over csrc/allocator.cc (the paged-KV block allocator,
    the serving scheduler's hot loop in native code). Error codes as the
    source gives them: ensure -1 (pool exhausted, nothing taken), -2 (more
    blocks than a sequence may hold)."""

    def __init__(self, path: str):
        lib = ctypes.CDLL(path)
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        lib.pkv_create.restype = i64
        lib.pkv_create.argtypes = [i64, i64, i64, i64]
        lib.pkv_destroy.restype = None
        lib.pkv_destroy.argtypes = [i64]
        lib.pkv_ensure.restype = i32
        lib.pkv_ensure.argtypes = [i64, i64, i64]
        lib.pkv_release.restype = i32
        lib.pkv_release.argtypes = [i64, i64]
        lib.pkv_adopt.restype = i32
        lib.pkv_adopt.argtypes = [i64, i64, ctypes.POINTER(i32), i64]
        lib.pkv_retain.restype = i32
        lib.pkv_retain.argtypes = [i64, ctypes.POINTER(i32), i64]
        lib.pkv_unref.restype = i32
        lib.pkv_unref.argtypes = [i64, ctypes.POINTER(i32), i64]
        lib.pkv_free_blocks.restype = i64
        lib.pkv_free_blocks.argtypes = [i64]
        lib.pkv_slot_blocks.restype = i64
        lib.pkv_slot_blocks.argtypes = [i64, i64]
        lib.pkv_tables.restype = i32
        lib.pkv_tables.argtypes = [i64, ctypes.POINTER(i32)]
        self._lib = lib

    def create(self, num_blocks, max_batch, max_blocks_per_seq,
               block_size) -> int:
        return int(self._lib.pkv_create(num_blocks, max_batch,
                                        max_blocks_per_seq, block_size))

    def destroy(self, handle: int):
        self._lib.pkv_destroy(handle)

    def ensure(self, handle: int, slot: int, tokens: int) -> int:
        return int(self._lib.pkv_ensure(handle, slot, tokens))

    def release(self, handle: int, slot: int) -> int:
        return int(self._lib.pkv_release(handle, slot))

    @staticmethod
    def _blocks_arg(blocks):
        arr = np.ascontiguousarray(blocks, np.int32)
        return (arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(arr), arr)

    def adopt(self, handle: int, slot: int, blocks) -> int:
        ptr, n, _keep = self._blocks_arg(blocks)
        return int(self._lib.pkv_adopt(handle, slot, ptr, n))

    def retain(self, handle: int, blocks) -> int:
        ptr, n, _keep = self._blocks_arg(blocks)
        return int(self._lib.pkv_retain(handle, ptr, n))

    def unref(self, handle: int, blocks) -> int:
        ptr, n, _keep = self._blocks_arg(blocks)
        return int(self._lib.pkv_unref(handle, ptr, n))

    def free_blocks(self, handle: int) -> int:
        return int(self._lib.pkv_free_blocks(handle))

    def slot_blocks(self, handle: int, slot: int) -> int:
        return int(self._lib.pkv_slot_blocks(handle, slot))

    def tables(self, handle: int, max_batch: int, max_blocks_per_seq: int,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        """The (max_batch, max_blocks_per_seq) int32 tables, into `out`
        (C-contiguous, of that shape) when given."""
        if out is None:
            out = np.zeros((max_batch, max_blocks_per_seq), np.int32)
        rc = self._lib.pkv_tables(
            handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise RuntimeError(f'pkv_tables failed rc={rc}')
        return out


def native_alloc() -> Optional[NativeAllocLib]:
    """Build-once, cached loader for the block-allocator library. Returns
    None when the toolchain is unavailable (callers fall back to the
    Python free list in serving/paged.py)."""
    global _alloc_cache, _alloc_failed
    if _alloc_cache is not None:
        return _alloc_cache
    if _alloc_failed:
        return None
    with _lock:
        if _alloc_cache is not None:
            return _alloc_cache
        try:
            _alloc_cache = NativeAllocLib(_build_library(_ALLOC_SRC,
                                                         _ALLOC_SO))
        except (OSError, subprocess.CalledProcessError) as e:
            _alloc_failed = True
            ppq_warning(f'native allocator build failed ({e}); '
                        f'falling back to the Python block allocator.')
            return None
    return _alloc_cache


# ------------------------------------------------ prefetching npy loader ---

_DL_SRC = os.path.join(_REPO_CSRC, 'dataloader.cc')
_DL_SO = os.path.join(_BUILD_DIR, 'libppq_tpu_torch_dataio.so')
_dl_cache: Optional['NativeDataLib'] = None
_dl_failed = False


class NativeDataLib:
    """ctypes surface over csrc/dataloader.cc (threaded npy prefetcher)."""

    def __init__(self, path: str):
        lib = ctypes.CDLL(path)
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        lib.dl_create.restype = i64
        lib.dl_create.argtypes = [i64, i64]
        lib.dl_submit.restype = i64
        lib.dl_submit.argtypes = [i64, ctypes.c_char_p]
        lib.dl_next_meta.restype = i32
        lib.dl_next_meta.argtypes = [i64, ctypes.POINTER(i64),
                                     ctypes.POINTER(i32),
                                     ctypes.POINTER(i32),
                                     ctypes.POINTER(i32),
                                     ctypes.POINTER(i64)]
        lib.dl_next_copy.restype = i32
        lib.dl_next_copy.argtypes = [i64, ctypes.POINTER(ctypes.c_uint8)]
        lib.dl_close.restype = None
        lib.dl_close.argtypes = [i64]
        self._lib = lib


def native_dataio() -> Optional[NativeDataLib]:
    """Build-once, cached loader for the npy prefetcher. Returns None when
    the toolchain is unavailable (utils/dataio.py falls back to np.load)."""
    global _dl_cache, _dl_failed
    if _dl_cache is not None:
        return _dl_cache
    if _dl_failed:
        return None
    with _lock:
        if _dl_cache is not None:
            return _dl_cache
        try:
            _dl_cache = NativeDataLib(_build_library(_DL_SRC, _DL_SO,
                                                     ('-pthread',)))
        except (OSError, subprocess.CalledProcessError) as e:
            _dl_failed = True
            ppq_warning(f'native dataio build failed ({e}); '
                        f'falling back to np.load.')
            return None
    return _dl_cache
