"""In-place column write for the decode burst's banked K/V buffers: the
CUDA kernel's wrapper and its plain version.

Counterpart of ppq_tpu/kernels/bank_write.py `bank_write_inplace`
(`_make_writer`). The kernel is in `ppq_tpu_torch/csrc/kv_write.cu`; its
source says what bounds it on the card and what one launch buys.

    for every buffer j:  bank.bufs[j][:, col] = news[j][:, 0]

The buffers are (B, CH, KV, Dh) and may be views of a larger buffer (any slot
stride; the trailing three dimensions dense); they are wrapped in a `Bank`,
which checks them once. news are (B, 1, KV, Dh); col is a Python int or a
one-element int32 tensor on the buffers' device, which the kernel reads
there. The caller guarantees 0 <= col < CH: a device-side col cannot be
checked without a host read, so the kernel writes nothing for a column
outside the buffers and sets a bit of the device's fault word, which
`loader.read_faults` reads (tests and `chip_smoke.py` do). The buffers are
updated in place and handed back.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .loader import (LAUNCHES, check, fault_word, library, pointer_array,
                     stream_of)

# pointers that fit one launch's arguments (csrc/kv_write.cu MAX_BANK)
MAX_ARRAYS = 128


def supports_bank(buf_shape) -> bool:
    """The JAX package's rule, kept so that both take the same branch: at
    least (B, CH, KV, Dh) with Dh a multiple of 128."""
    return len(buf_shape) >= 4 and buf_shape[-1] % 128 == 0


class Bank:
    """A set of banked buffers, checked once: a decode burst writes one
    column into the same buffers at every step, and the checks of 2L
    buffers cost the host more than the launch."""

    def __init__(self, bufs: Sequence[torch.Tensor]):
        self.bufs = tuple(bufs)
        if not self.bufs:
            raise ValueError('bank_write: no buffers')
        first = self.bufs[0]
        self.device, self.dtype = first.device, first.dtype
        self.new_shape = (first.shape[0], 1) + tuple(first.shape[2:])
        self.B, self.CH = first.shape[:2]
        if first.device.type != 'cuda':
            return
        self.row_bytes = first[0, 0].numel() * first.element_size()
        self.slot_bytes = first.stride(0) * first.element_size()
        for buf in self.bufs:
            if buf.shape != first.shape or buf.dtype != first.dtype \
                    or buf.device != first.device \
                    or buf.stride(0) != first.stride(0) \
                    or not buf[0].is_contiguous():
                raise ValueError('bank_write takes buffers of one shape, type '
                                 'and slot stride, dense below the slot axis')
            if buf.data_ptr() % 16:
                raise ValueError('bank_write takes 16-byte aligned tensors')
        if self.row_bytes % 16 or self.slot_bytes % 16:
            raise ValueError(f'bank_write moves 16-byte vectors: a row of '
                             f'{self.row_bytes} bytes does not divide')
        self.fault = fault_word(first.device)
        self.parts = [(pointer_array(self.bufs[at:at + MAX_ARRAYS]), at,
                       len(self.bufs[at:at + MAX_ARRAYS]))
                      for at in range(0, len(self.bufs), MAX_ARRAYS)]


def bank_write_plain(bank: Bank, news: Sequence[torch.Tensor],
                     col) -> Tuple[torch.Tensor, ...]:
    """Indexed in-place assignment, on any device. A tensor `col` is used as
    an index on its device: no host read."""
    if isinstance(col, torch.Tensor):
        index = col.reshape(1).to(torch.int64)
        for buf, new in zip(bank.bufs, news):
            buf.index_copy_(1, index, new.to(buf.dtype))
    else:
        for buf, new in zip(bank.bufs, news):
            buf[:, int(col)] = new[:, 0].to(buf.dtype)
    return bank.bufs


def bank_write_inplace(bank: Bank, news: Sequence[torch.Tensor],
                       col) -> Tuple[torch.Tensor, ...]:
    """Write one column into every buffer of the bank, in place, in one
    launch per MAX_ARRAYS buffers. CPU tensors take the plain version; CUDA
    tensors the kernel."""
    news = tuple(news)
    if len(bank.bufs) != len(news):
        raise ValueError(f'bank_write: {len(bank.bufs)} buffers, '
                         f'{len(news)} columns')
    if bank.device.type == 'cpu':
        return bank_write_plain(bank, news, col)
    if bank.device.type != 'cuda':
        raise ValueError(f'bank_write runs on cpu or cuda, not {bank.device}')
    pointers = []
    for new in news:
        if new.shape != bank.new_shape or new.dtype != bank.dtype \
                or new.device != bank.device or not new.is_contiguous():
            raise ValueError(f'bank_write takes contiguous {bank.new_shape} '
                             f'columns of the buffers\' type and device, got '
                             f'{tuple(new.shape)} {new.dtype} on {new.device}')
        pointers.append(new.data_ptr())
    if any(p % 16 for p in pointers):
        raise ValueError('bank_write takes 16-byte aligned tensors')
    if isinstance(col, torch.Tensor):
        if col.numel() != 1 or col.dtype != torch.int32 \
                or col.device != bank.device:
            raise ValueError('bank_write takes col as one int32 on the '
                             'buffers\' device')
    else:
        if not 0 <= int(col) < bank.CH:
            raise ValueError(f'bank_write: column {col} outside buffers of '
                             f'{bank.CH} columns')
        col = torch.tensor([int(col)], dtype=torch.int32, device=bank.device)
    lib = library('kv_write')
    with torch.cuda.device(bank.device):
        stream = stream_of(bank.device)
        for dsts, at, count in bank.parts:
            srcs = (ctypes.c_void_p * count)(*pointers[at:at + count])
            rc = lib.ppq_bank_write(dsts, srcs, count, bank.B, bank.CH,
                                    bank.row_bytes, bank.slot_bytes,
                                    col.data_ptr(),
                                    bank.fault.data_ptr(), stream)
            check(rc, 'bank_write')
            LAUNCHES['bank_write'] += 1
    return bank.bufs
