"""In-place window write into dense (L, B, S, ...) cache slabs: the CUDA
kernel's wrapper and its plain version.

Counterpart of ppq_tpu/kernels/window_write.py `window_write_inplace`
(`_make_writer`). The kernel is in `ppq_tpu_torch/csrc/kv_write.cu`; its
source says what bounds it on the card.

    for every slab j, layer l, slot b:
        slabs[j][l, b, pos[b] : pos[b] + n] = news[j][l, b]

slabs are (L, B, S, KV, Dh), news (L, B, n, KV, Dh), write_pos (B,) int32 on
the slabs' device, read there. The caller guarantees 0 <= write_pos and
write_pos + n <= S: positions on the device cannot be checked without a host
read, so the kernel writes nothing for a slot whose window does not fit and
sets a bit of the device's fault word (`loader.read_faults`). The slabs are
updated in place and handed back.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .loader import (LAUNCHES, check, fault_word, library, pointer_array,
                     stream_of)

# pointers that fit one launch's arguments (csrc/kv_write.cu MAX_WINDOW)
MAX_ARRAYS = 8


def supports_dense(slab_shape) -> bool:
    """The JAX package's rule, kept so that both take the same branch: the
    last dimension a multiple of 128 (the f32 scale slabs, KV wide, go
    through the indexed write)."""
    return len(slab_shape) >= 4 and slab_shape[-1] % 128 == 0


def window_write_plain(slabs: Sequence[torch.Tensor],
                       news: Sequence[torch.Tensor],
                       write_pos: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Indexed in-place assignment, on any device, with no host read of
    write_pos. The trailing dimensions may differ from slab to slab."""
    for slab, new in zip(slabs, news):
        B, n = new.shape[1], new.shape[2]
        rows = write_pos.to(torch.int64)[:, None] + torch.arange(
            n, device=slab.device)                           # (B, n)
        slots = torch.arange(B, device=slab.device)[:, None].expand(B, n)
        slab[:, slots, rows] = new.to(slab.dtype)
    return tuple(slabs)


def window_write_inplace(slabs: Sequence[torch.Tensor],
                         news: Sequence[torch.Tensor],
                         write_pos: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Write per-slot n-row windows into the slabs, in place, all slabs in
    one launch. CPU tensors take the plain version; CUDA tensors the
    kernel."""
    slabs, news = tuple(slabs), tuple(news)
    if not slabs or len(slabs) != len(news):
        raise ValueError(f'window_write: {len(slabs)} slabs, {len(news)} windows')
    first = slabs[0]
    if first.device.type == 'cpu':
        return window_write_plain(slabs, news, write_pos)
    if first.device.type != 'cuda':
        raise ValueError(f'window_write runs on cpu or cuda, not {first.device}')
    if len(slabs) > MAX_ARRAYS:
        raise ValueError(f'window_write takes at most {MAX_ARRAYS} slabs')
    L, B, S = first.shape[:3]
    n = news[0].shape[2]
    row_bytes = first[0, 0, 0].numel() * first.element_size()
    new_shape = (L, B, n) + tuple(first.shape[3:])
    for slab, new in zip(slabs, news):
        if slab.shape != first.shape or slab.dtype != first.dtype \
                or slab.device != first.device or not slab.is_contiguous():
            raise ValueError('window_write takes contiguous slabs of one '
                             'shape and type')
        if tuple(new.shape) != new_shape or new.dtype != slab.dtype \
                or new.device != slab.device or not new.is_contiguous():
            raise ValueError(f'window_write takes contiguous {new_shape} '
                             f'windows of the slabs\' type, got '
                             f'{tuple(new.shape)} {new.dtype}')
        if slab.data_ptr() % 16 or new.data_ptr() % 16:
            raise ValueError('window_write takes 16-byte aligned tensors')
    if row_bytes % 16:
        raise ValueError(f'window_write moves 16-byte vectors: a row of '
                         f'{row_bytes} bytes does not divide')
    if n > S:
        raise ValueError(f'window of {n} rows in a slab of {S}')
    if write_pos.dtype != torch.int32 or write_pos.shape != (B,) \
            or write_pos.device != first.device or not write_pos.is_contiguous():
        raise ValueError(f'window_write takes write_pos as int32 ({B},) on '
                         f'the slabs\' device')
    lib = library('kv_write')
    with torch.cuda.device(first.device):
        rc = lib.ppq_window_write(
            pointer_array(slabs), pointer_array(news), len(slabs), L, B, S, n,
            row_bytes, write_pos.data_ptr(),
            fault_word(first.device).data_ptr(), stream_of(first.device))
    check(rc, 'window_write')
    LAUNCHES['window_write'] += 1
    return slabs
