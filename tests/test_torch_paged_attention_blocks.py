"""The block sizes that the paged-attention kernels (rows 11 and 12) take,
checked on the CPU: every block size the engine can hand them passes the
wrappers' checks for the card, and one the kernel does not take raises
ValueError before anything is launched.

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

