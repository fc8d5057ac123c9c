"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each source under `ppq_tpu_torch/csrc/` is compiled by `nvcc` for `sm_90a`
into its own shared library with a plain C interface, in
`ppq_tpu_torch/csrc/build/` (listed in `.gitignore`). A library is rebuilt
when its source is newer. Nothing is built or loaded at import time: this
module is imported on machines without a card or a CUDA toolkit, where only
the kernels' plain versions run.

Every kernel wrapper counts its launches in `LAUNCHES`, so a run can show
that a path went through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(SRC_DIR, 'build')

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC',
              # no fused multiply-add and no fast math: the kernels must
              # round exactly like their plain versions
              '-fmad=false', '-Xptxas', '-v']

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
_INT = ctypes.c_int

# library name -> (source file, {C entry point: argtypes})
LIBRARIES: Dict[str, tuple] = {
    'fake_quant': ('fake_quant.cu', {
        'ppq_fake_quant_tensorwise':
            [_P, _P, _I64, _F, _F, _F, _F, _INT, _INT, _P],
        'ppq_fake_quant_channelwise':
            [_P, _P, _I64, _P, _P, _I64, _I64, _F, _F, _INT, _INT, _P],
    }),
    'histogram': ('histogram.cu', {
        'ppq_histogram': [_P, _I64, _F, _INT, _INT, _P, _P],
    }),
}

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {
    'fake_quant_tensorwise': 0,
    'fake_quant_channelwise': 0,
    'histogram': 0,
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels of ppq_tpu_torch '
                           'are built on the machine with the card')
    return path


def _paths(name: str):
    src = os.path.join(SRC_DIR, LIBRARIES[name][0])
    so = os.path.join(BUILD_DIR, f'libppq_{name}.so')
    return src, so


def _stale(name: str) -> bool:
    src, so = _paths(name)
    return not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src)


def build(names: Iterable[str] = tuple(LIBRARIES)) -> Dict[str, float]:
    """Compile the named libraries that are missing or stale, all nvcc
    processes at once. Returns the seconds each build took (0 for one that
    was up to date). Raises with nvcc's output if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    started = {}
    for name in names:
        if not _stale(name):
            continue
        src, so = _paths(name)
        tmp = f'{so}.{os.getpid()}.tmp'
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, '-o', tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, so, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed: List[str] = []
    for name, (proc, tmp, so, t0) in started.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f'{name} (nvcc exit {proc.returncode}):\n{out}')
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError('CUDA kernel build failed: ' + '\n'.join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            if _stale(name):
                build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            for fn, argtypes in LIBRARIES[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a CUDA error code returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA error {rc} at launch')
