"""Native C++ solver library: built at first use, bound with ctypes.

Counterpart of the solver half of ppq_tpu/utils/native.py. The source,
`ppq_tpu_torch/csrc/solvers.cc`, is a copy of the repository's
`csrc/solvers.cc` (KL and MSE clip searches, isotonic regression, the
histogram MSE loss) with a plain extern "C" interface. It is compiled with
`g++ -O3 -shared -fPIC -std=c++17` into `ppq_tpu_torch/csrc/build/` (listed in
`.gitignore`) the first time a search asks for it, never at import. Where the
build fails, a warning is logged and the searches take their numpy twins
(`quantization/solvers.py`), as the JAX package does.
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

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    'csrc', 'solvers.cc')
_BUILD_DIR = os.path.join(os.path.dirname(_SRC), 'build')
_SO = os.path.join(_BUILD_DIR, 'libppq_tpu_torch_solvers.so')


def _build() -> str:
    """Compile the library unless it is newer than its source. The output is
    written under a name of this process and renamed into place, so that
    processes building at once never load a half-written file."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(_SO) and \
            os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    tmp = f'{_SO}.{os.getpid()}.tmp'
    cmd = ['g++', '-O3', '-shared', '-fPIC', '-std=c++17', _SRC, '-o', tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)
    return _SO


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
