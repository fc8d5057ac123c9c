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

import contextlib
import ctypes
import gc
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List

import torch
from torch._subclasses.fake_tensor import FakeTensor

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(SRC_DIR, 'build')

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']
# the fake-quant libraries: no fused multiply-add and no fast math, they
# must round exactly like their plain versions. The matmul and copy
# libraries keep the compiler's default (their epilogues name each rounding)
EXACT_FLAGS = ['-fmad=false']

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
_INT = ctypes.c_int

# headers that every source includes: a library is stale when one is newer
HEADERS = ('rounding.cuh', 'channel_index.cuh')

# library name -> (source file, {C entry point: argtypes}, extra nvcc flags)
LIBRARIES: Dict[str, tuple] = {
    'fake_quant': ('fake_quant.cu', {
        'ppq_fake_quant_tensorwise':
            [_P, _P, _I64, _F, _F, _F, _F, _INT, _INT, _P],
        'ppq_fake_quant_tensorwise_dev':
            [_P, _P, _I64, _P, _P, _F, _F, _INT, _INT, _P],
        'ppq_fake_quant_channelwise':
            [_P, _P, _I64, _P, _P, _I64, _I64, _F, _F, _INT, _INT, _P],
    }, EXACT_FLAGS),
    'fake_quant_bwd': ('fake_quant_bwd.cu', {
        'ppq_fake_quant_bwd_tensorwise':
            [_P, _P, _P, _I64, _P, _P, _F, _F, _INT, _P, _INT, _P, _P, _P],
        'ppq_fake_quant_bwd_channelwise':
            [_P, _P, _P, _I64, _P, _P, _I64, _I64, _F, _F, _INT, _INT, _INT,
             _P, _P, _P, _P, _P],
    }, EXACT_FLAGS),
    'floating': ('floating.cu', {
        'ppq_floating_quant_tensorwise':
            [_P, _P, _I64, _F, _P, _F, _F, _INT, _F, _F, _F, _P],
        'ppq_floating_quant_channelwise':
            [_P, _P, _I64, _P, _I64, _I64, _F, _F, _INT, _F, _F, _F, _P],
        'ppq_floating_quant_bwd':
            [_P, _P, _P, _I64, _F, _P, _F, _F, _P],
    }, EXACT_FLAGS),
    'histogram': ('histogram.cu', {
        'ppq_histogram': [_P, _I64, _F, _INT, _INT, _P, _P],
    }, EXACT_FLAGS),
    'qmm': ('qmm.cu', {
        'ppq_qmm_int8':
            [_P, _P, _P, _P, _P, _INT, _P, _INT, _I64, _I64, _I64, _INT, _P,
             _P, _P],
        'ppq_qmm_gateup':
            [_P, _P, _P, _P, _P, _INT, _I64, _I64, _I64, _INT, _P, _P, _P],
        'ppq_qmm_int4':
            [_P, _P, _P, _P, _P, _INT, _P, _INT, _I64, _I64, _I64, _INT, _P,
             _P, _P],
        'ppq_qmm_gateup_int4':
            [_P, _P, _P, _P, _P, _INT, _I64, _I64, _I64, _INT, _P, _P, _P],
    }, []),
    'kv_write': ('kv_write.cu', {
        'ppq_bank_write':
            [_P, _P, _INT, _I64, _I64, _I64, _I64, _P, _P, _P],
        'ppq_window_write':
            [_P, _P, _INT, _I64, _I64, _I64, _I64, _I64, _P, _P, _P],
        'ppq_pool_write': [_P] * 10 + [_I64] * 12 + [_P],
    }, []),
    'paged_attention': ('paged_attention.cu', {
        'ppq_paged_attention':
            [_P] * 9 + [_INT] + [_I64] * 9 + [_F, _P],
        'ppq_paged_attention_buffered':
            [_P] * 13 + [_INT] + [_I64] * 17 + [_F, _P],
        'ppq_paged_attention_occupancy': [_INT, _I64, _I64, _INT, _P],
        'ppq_empty_launch': [_P],
    }, []),
}

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {
    'fake_quant_tensorwise': 0,
    'fake_quant_channelwise': 0,
    'histogram': 0,
    'fake_quant_bwd_tensorwise': 0,
    'fake_quant_bwd_channelwise': 0,
    'floating_quant': 0,
    'floating_quant_bwd': 0,
    'qmm_int8': 0,
    'qmm_gateup': 0,
    'qmm_int4': 0,
    'qmm_gateup_int4': 0,
    'paged_attention_fused': 0,
    'paged_attention_grouped': 0,
    'paged_attention_buffered': 0,
    'bank_write': 0,
    'window_write': 0,
    'pool_write': 0,
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


@contextlib.contextmanager
def graph_capture(graph, pool=None):
    """`torch.cuda.graph(graph, pool=pool)` with Python's cyclic garbage
    collector held off for the capture: every CUDA graph of the port is
    captured through it. A collection that ran inside a capture could free
    another graph's objects (a CUDA graph, a memory pool, pinned buffers,
    an unreachable serving engine's), whose destructors call CUDA APIs that
    invalidate the capture in progress (cudaErrorStreamCaptureInvalidated:
    seen with three engines on one set of weights in one process). The
    garbage is collected after the capture instead."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            yield
    finally:
        if enabled:
            gc.enable()


def traced(x) -> bool:
    """Whether `x` is a tensor of a trace (torch.export, torch.compile)
    rather than one holding data: a wrapper then calls its custom operator
    (`kernels/ops.py`), which the trace keeps as one opaque node."""
    return torch.compiler.is_compiling() or isinstance(x, FakeTensor)


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
    if not os.path.exists(so):
        return True
    sources = [src] + [os.path.join(SRC_DIR, h) for h in HEADERS]
    return os.path.getmtime(so) < max(os.path.getmtime(f) for f in sources)


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
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, *LIBRARIES[name][2],
                                 '-o', tmp, src],
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


# bits of the fault word: inputs a kernel was given that it must not be
# given, found on the card (where checking them would cost a host read)
FAULTS = {
    1: 'paged attention: a seq_lens entry outside [0, blocks * block size]',
    2: 'paged attention: a block-table row outside the pool',
    4: 'bank_write: a column outside the buffers',
    8: 'window_write: a window outside the slab',
    16: 'pool_write: a position outside the block table',
    32: 'pool_write: a block-table row outside the pool',
}
_fault_words: Dict[torch.device, torch.Tensor] = {}


def fault_word(device) -> torch.Tensor:
    """The device's fault word: one int32 that kernels OR their fault bits
    into. Allocated at first use; nothing reads it but read_faults."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    with _lock:
        word = _fault_words.get(device)
        if word is None:
            word = torch.zeros(1, dtype=torch.int32, device=device)
            _fault_words[device] = word
        return word


def read_faults(device=None, reset: bool = True) -> List[str]:
    """What the kernels on `device` (every device used, if None) reported
    since the last reset, as FAULTS' descriptions; empty when all inputs were
    in range. Reads the card (a synchronisation)."""
    words = [fault_word(device)] if device is not None \
        else list(_fault_words.values())
    bits = 0
    for word in words:
        bits |= int(word.item())
        if reset:
            word.zero_()
    return [text for bit, text in FAULTS.items() if bits & bit]


def check(rc: int, what: str) -> None:
    """Raise on a CUDA error code returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA error {rc} at launch')


def stream_of(device) -> ctypes.c_void_p:
    """PyTorch's current stream on `device`, as the C entry points take it."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def pointer_array(tensors) -> ctypes.Array:
    """The tensors' device addresses as a C array of pointers, for an entry
    point that takes several arrays in one launch."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def check_cuda_input(x, what: str) -> None:
    """The kernels take contiguous float32 tensors."""
    if x.dtype != torch.float32:
        raise TypeError(f'{what} takes float32, got {x.dtype}')
    if not x.is_contiguous():
        raise ValueError(f'{what} takes a contiguous tensor')
