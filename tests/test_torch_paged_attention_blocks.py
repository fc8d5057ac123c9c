"""The block sizes that the paged-attention kernels (rows 11, 12 and 13)
take, checked on the CPU: every block size the engine can hand them passes
the wrappers' checks for the card, and one the kernel does not take raises
ValueError before anything is launched; for row 13 also the buffer widths
and the scales' alignment.

The wrappers run their plain versions on CPU tensors, so a CUDA tensor is
stood in for by `_OnCard`: a CPU tensor that reports a CUDA device. The
wrapper then takes the kernel's branch and checks its inputs as on the
card; `_run`, which allocates on the card and launches, is replaced by a
recorder.
"""

import pytest
import torch

from ppq_tpu_torch.kernels import LAUNCHES
from ppq_tpu_torch.kernels import paged_attention as tpa
from ppq_tpu_torch.serving.paged import gather_window

KV, REP, DH = 1, 2, 128


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The tensors here are small. With one thread PyTorch opens no OpenMP
    region, whose idle workers would otherwise spin on the cores that the
    other test processes need."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device('cuda', 0)


def _on_card(t):
    return t.as_subclass(_OnCard)


@pytest.fixture
def launches(monkeypatch):
    """The block sizes that reached the launch, in order."""
    seen = []

    def record(what, q, pool, scale, tables, seq_lens, MB, NB, SCP, group):
        seen.append((what, pool.shape[-2]))
    monkeypatch.setattr(tpa, '_run', record)
    return seen


def _fused(blk, mb=2, B=2):
    q = torch.zeros(B, KV, REP, DH, dtype=torch.bfloat16)
    pool = torch.zeros(B * mb, 2, blk, KV * DH, dtype=torch.int8)
    scale = torch.zeros(B * mb, 2, KV, blk)
    tables = torch.arange(B * mb, dtype=torch.int32).reshape(B, mb)
    lens = torch.full((B,), blk, dtype=torch.int32)
    return [_on_card(t) for t in (q, pool, scale, tables, lens)]


def _grouped(blk, mb=2, B=2):
    q = torch.zeros(B, KV, REP, DH, dtype=torch.bfloat16)
    kv = torch.zeros(B * mb, 2, blk, KV * DH, dtype=torch.int8)
    sc = torch.zeros(B * mb, 2, KV, max(blk, 128))
    lens = torch.full((B,), blk, dtype=torch.int32)
    return [_on_card(t) for t in (q, kv, sc, lens)]


def _engine_blocks():
    """(block size, grouped) of the ragged read for every window the engine
    can pick (`serving/model.py` `burst_forward`: a multiple of 32 up to
    max_seq_len, here 32..1024), grouped or not, as its rule reads."""
    picks = set()
    for cap in range(32, 1025, 32):
        for prefer_grouped in (True, False):
            grouped = prefer_grouped or cap <= 64
            if grouped:
                blk = cap if cap <= 64 else max(32, min(512, cap // 2))
            elif cap <= 512:
                blk = cap
            elif cap % 512 == 0:
                blk = 512
            else:
                blk = max(128, min(512, cap // 2))
            picks.add((blk, grouped))
    return sorted(picks)


def _paged_blocks():
    """The block sizes of path G's window (`gather_window`) over a pool of
    256-position blocks, for every read bucket the engine asks for."""
    pool = {'kv': torch.zeros(1, 9, 2, 256, 8, dtype=torch.int8)}
    tables = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    return sorted({gather_window(pool, tables, bucket)[2]
                   for bucket in (32, 64, 128, 256, 512, 1024)})


def test_engine_block_sizes_cover_the_rule():
    blocks = _engine_blocks()
    assert (32, True) in blocks and (64, True) in blocks
    assert (48, True) in blocks and (512, False) in blocks
    assert (272, False) in blocks and (992, False) not in blocks
    assert _paged_blocks() == [32, 64, 128, 256, 512]


@pytest.mark.parametrize('blk,grouped', _engine_blocks())
def test_every_engine_block_size_passes_the_kernel_checks(blk, grouped,
                                                          launches):
    before = dict(LAUNCHES)
    if grouped:
        q, kv, sc, lens = _grouped(blk)
        tpa.paged_attention_decode_grouped(q, kv, sc, lens, block_size=blk,
                                           group=2)
        assert launches == [('paged_attention_grouped', blk)]
    else:
        q, pool, scale, tables, lens = _fused(blk)
        tpa.paged_attention_decode_fused(q, pool, scale, tables, lens,
                                         block_size=blk)
        assert launches == [('paged_attention_fused', blk)]
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize('blk', _paged_blocks())
def test_every_paged_window_block_size_passes_the_kernel_checks(blk,
                                                                launches):
    q, kv, sc, lens = _grouped(blk)
    tpa.paged_attention_decode_grouped(q, kv, sc, lens, block_size=blk,
                                       group=1)
    assert launches == [('paged_attention_grouped', blk)]


@pytest.mark.parametrize('blk', [8, 24, 40, 2064, 4096])
@pytest.mark.parametrize('grouped', [False, True], ids=['fused', 'grouped'])
def test_a_block_size_the_kernel_does_not_take_raises_before_launch(
        blk, grouped, launches):
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match='block size'):
        if grouped:
            q, kv, sc, lens = _grouped(blk, mb=1)
            tpa.paged_attention_decode_grouped(q, kv, sc, lens,
                                               block_size=blk, group=2)
        else:
            q, pool, scale, tables, lens = _fused(blk, mb=1)
            tpa.paged_attention_decode_fused(q, pool, scale, tables, lens,
                                             block_size=blk)
    assert launches == [] and dict(LAUNCHES) == before


def test_unaligned_scales_raise_before_launch(launches):
    """The kernel copies the scales 16 bytes at a time."""
    q, pool, scale, tables, lens = _fused(32)
    odd = _on_card(torch.zeros(scale.numel() + 1)[1:].view(scale.shape))
    with pytest.raises(ValueError, match='aligned'):
        tpa.paged_attention_decode_fused(q, pool, odd, tables, lens,
                                         block_size=32)
    assert launches == []



# ------------------------------------------------- row 13: pool + buffer ----

@pytest.fixture
def buffered_launches(monkeypatch):
    """(block size, buffer width) of each row-13 call that reached the
    launch."""
    seen = []

    def record(what, q, codes, scales, tables, seq_lens, step, strides):
        seen.append((codes[0].shape[1], codes[2].shape[1]))
    monkeypatch.setattr(tpa, '_run_buffered', record)
    return seen


def _buffered(blk, nbuf=32, mb=2, B=2, int8=True, offset=0, slot_pad=0):
    """Row 13's inputs on the card: a fused pool's strided planes (K, V and
    their scales, as the engine holds them), tables, fills, a buffer and
    its scales; `offset` floats shift the buffer scales off a 16-byte
    boundary, `slot_pad` widens their slot stride."""
    NB = B * mb + 1
    dtype = torch.int8 if int8 else torch.bfloat16
    q = torch.zeros(B, KV, REP, DH, dtype=torch.bfloat16)
    pool = torch.zeros(NB, 2, blk, KV * DH, dtype=dtype)
    scale = torch.zeros(NB, 2, KV, blk)
    tables = torch.arange(1, B * mb + 1, dtype=torch.int32).reshape(B, mb)
    lens = torch.full((B,), blk, dtype=torch.int32)
    kb = torch.zeros(B, nbuf, KV * DH, dtype=dtype)
    vb = torch.zeros(B, nbuf, KV * DH, dtype=dtype)
    wide = torch.zeros(2 * B * (KV * nbuf + slot_pad) + offset)[offset:]
    bufsc = wide.view(2, B, KV * nbuf + slot_pad)[:, :, :KV * nbuf] \
        .unflatten(2, (KV, nbuf))
    args = [q, pool[:, 0], pool[:, 1], scale[:, 0], scale[:, 1], tables, lens,
            kb, vb, bufsc[0], bufsc[1]]
    if not int8:
        args[3] = args[4] = args[9] = args[10] = None
    return [None if t is None else _on_card(t) for t in args]


def _pool_blocks():
    """The pool block sizes the paged engine can hold (`ServingEngine`:
    kv_block_size a multiple of 128 dividing max_seq_len, capped there),
    up to the kernels' largest block."""
    picks = set()
    for seq in range(128, tpa.KERNEL_MAX_BLOCK + 1, 128):
        for kv_block in range(128, tpa.KERNEL_MAX_BLOCK + 1, 128):
            blk = min(kv_block, seq)
            if seq % blk == 0:
                picks.add(blk)
    return sorted(picks)


@pytest.mark.parametrize('int8', [True, False], ids=['int8', 'bf16'])
@pytest.mark.parametrize('blk', _pool_blocks())
def test_every_pool_block_size_passes_the_buffered_checks(blk, int8,
                                                          buffered_launches):
    before = dict(LAUNCHES)
    for nbuf in (8, 32):            # path G's burst buffers
        tpa.paged_attention_decode_buffered(*_buffered(blk, nbuf, int8=int8),
                                            31, block_size=blk)
    assert buffered_launches == [(blk, 8), (blk, 32)]
    assert dict(LAUNCHES) == before


def test_buffered_scales_with_another_slot_stride_pass(buffered_launches):
    args = _buffered(256, 32, slot_pad=4)
    assert args[9].stride(0) == KV * 32 + 4
    tpa.paged_attention_decode_buffered(*args, 5, block_size=256)
    assert buffered_launches == [(256, 32)]


@pytest.mark.parametrize('blk', [8, 24, 40, 2064, 4096])
def test_a_block_size_the_buffered_kernel_does_not_take_raises(
        blk, buffered_launches):
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match='block size'):
        tpa.paged_attention_decode_buffered(*_buffered(blk, mb=1), 0,
                                            block_size=blk)
    assert buffered_launches == [] and dict(LAUNCHES) == before


@pytest.mark.parametrize('nbuf,int8', [(6, True), (30, True), (2052, True),
                                       (2052, False)])
def test_a_buffer_width_the_buffered_kernel_does_not_take_raises(
        nbuf, int8, buffered_launches):
    """Scales are copied 4 columns at a time: with an int8 pool the width is
    a multiple of 4; every width is at most the kernel's largest block."""
    with pytest.raises(ValueError, match='buffer width'):
        tpa.paged_attention_decode_buffered(*_buffered(128, nbuf, int8=int8),
                                            0, block_size=128)
    assert buffered_launches == []


def test_a_bf16_buffer_of_any_width_passes(buffered_launches):
    tpa.paged_attention_decode_buffered(*_buffered(128, 6, int8=False), 3,
                                        block_size=128)
    assert buffered_launches == [(128, 6)]


@pytest.mark.parametrize('offset,slot_pad', [(1, 0), (0, 2)],
                         ids=['start', 'slot-stride'])
def test_unaligned_buffer_scales_raise_before_launch(offset, slot_pad,
                                                     buffered_launches):
    """The scales of 4 positions are one 16-byte copy: their rows' starts
    and their slot stride must keep that alignment."""
    with pytest.raises(ValueError, match='aligned'):
        tpa.paged_attention_decode_buffered(
            *_buffered(128, 32, offset=offset, slot_pad=slot_pad), 0,
            block_size=128)
    assert buffered_launches == []
