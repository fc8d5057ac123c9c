"""The serving kernels of ppq_tpu_torch against ppq_tpu's Pallas kernels, on
the CPU: the same numpy-seeded inputs through `qmm_int8`, `qmm_gateup`,
`bank_write_inplace` and `window_write_inplace` of the JAX package in
interpret mode, and through the port's wrappers, which on CPU tensors run
the plain versions that the CUDA kernels are held against on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppq_tpu.kernels import bank_write as jbank
from ppq_tpu.kernels import qmm as jqmm
from ppq_tpu.kernels import window_write as jwindow
from ppq_tpu_torch.kernels import (LAUNCHES, Bank, bank_write_inplace,
                                   qmm_gateup, qmm_int8, supports_bank,
                                   supports_dense, window_write_inplace)
from ppq_tpu_torch.kernels import qmm as tqmm

# Both sides multiply bf16-rounded operands exactly in f32 and differ only in
# the order of the f32 sum over D <= 512 terms, and in how sigmoid is
# evaluated: a few ulp of the row's absolute mass. A bf16 output adds one
# rounding, and a sum that lands next to a rounding boundary may fall either
# way: one bf16 ulp (2^-8 relative).
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-4)

EPILOGUES = [(False, False), (True, False), (False, True), (True, True)]


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The tensors here are tiny. With one thread PyTorch opens no OpenMP
    region, whose idle workers would otherwise spin on the cores that the
    other test processes need."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bf16(a):
    """float32 values that bf16 holds exactly."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _qmm_case(B, D, F, seed):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((B, D)).astype(np.float32))
    w = rng.integers(-127, 128, size=(D, F)).astype(np.int8)
    scale = (rng.random(F) * 0.01 + 0.001).astype(np.float32)
    row = (rng.random(B) + 0.5).astype(np.float32)
    res = _bf16(rng.standard_normal((B, F)).astype(np.float32))
    return x, w, scale, row, res


@pytest.mark.parametrize('out', ['float32', 'bfloat16'])
@pytest.mark.parametrize('has_row,has_res', EPILOGUES)
@pytest.mark.parametrize('B,D,F', [(1, 256, 128), (5, 512, 384)])
def test_qmm_int8_vs_pallas(B, D, F, has_row, has_res, out):
    x, w, scale, row, res = _qmm_case(B, D, F, seed=B + D + F)
    want = jqmm.qmm_int8(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(scale),
        out_dtype=getattr(jnp, out), interpret=True,
        row_scale=jnp.asarray(row) if has_row else None,
        residual=jnp.asarray(res, jnp.bfloat16) if has_res else None)
    got = qmm_int8(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
        torch.from_numpy(scale), out_dtype=getattr(torch, out),
        row_scale=torch.from_numpy(row) if has_row else None,
        residual=torch.from_numpy(res).bfloat16() if has_res else None)
    assert got.dtype == getattr(torch, out) and tuple(got.shape) == (B, F)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        **(F32_TOL if out == 'float32' else BF16_TOL))


@pytest.mark.parametrize('out', ['float32', 'bfloat16'])
@pytest.mark.parametrize('has_row', [False, True])
@pytest.mark.parametrize('B,D,F', [(1, 256, 128), (8, 512, 256)])
def test_qmm_gateup_vs_pallas(B, D, F, has_row, out):
    x, w, scale, row, _ = _qmm_case(B, D, 2 * F, seed=B + D + F + 1)
    want = jqmm.qmm_gateup(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(scale),
        out_dtype=getattr(jnp, out), interpret=True,
        row_scale=jnp.asarray(row) if has_row else None)
    got = qmm_gateup(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
        torch.from_numpy(scale), out_dtype=getattr(torch, out),
        row_scale=torch.from_numpy(row) if has_row else None)
    assert got.dtype == getattr(torch, out) and tuple(got.shape) == (B, F)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        **(F32_TOL if out == 'float32' else BF16_TOL))


def test_qmm_routing_rules_match():
    """The port tiles what the JAX kernel tiles at serving shapes (it drops
    only the fast-memory budget), so both packages route a matmul alike."""
    for d, f, b in [(256, 128, 1), (512, 256, 8), (2048, 4096, 128),
                    (5632, 2048, 128), (2048, 32768, 128), (128, 256, 4),
                    (256, 192, 4), (384, 128, 4)]:
        assert tqmm.supports(d, f, b) == jqmm.supports(d, f, b), (d, f, b)
    for d, f2, b in [(256, 256, 8), (2048, 11264, 128), (256, 384, 4),
                     (128, 512, 4)]:
        assert tqmm.supports_gateup(d, f2, b, 8) == \
            jqmm.supports_gateup(d, f2, b, 8), (d, f2, b)
    # the INT4 body: ported, with the same rule
    assert tqmm.supports_gateup(512, 512, 4, 4) == \
        jqmm.supports_gateup(512, 512, 4, 4) is True


# split-K of every body: decode shapes (M = 128) of the 1B model, prefill
# shapes up to the 2 MiB cap on x, and small ones; D is the unpacked depth,
# and the INT4 bodies take D a multiple of 512 (the JAX package's rule)
SPLIT_M = (1, 37, 128, 129, 200, 512)
SPLIT_DF = ((256, 128), (2048, 2048), (2048, 4096), (5632, 2048),
            (2048, 32768), (2048, 5632))
SPLIT_DF_INT4 = ((512, 128), (1024, 384), (2048, 2048), (2048, 4096),
                 (5632, 2048), (2048, 5632))


def _check_splits(M, D, F, gateup, int4):
    """The splits cut [0, D) into S ranges of whole 64-deep steps, none
    empty, every one but the last at least _MIN_SPLIT_STEPS steps deep, no
    more than about two blocks an SM need for one row tile; one split where
    the column tiles alone give every SM a block (so wherever one row
    tile's grid has two blocks an SM); the workspace holds S planes of the
    (M, F) product, both panels for gate-up, none without a split; and the
    launch the smoke logs says the same."""
    S = tqmm._splits(D, F, gateup, int4)
    ranges = tqmm.split_ranges(D, F, gateup, int4)
    assert len(ranges) == S >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == D
    assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
    assert all(a % 64 == 0 and b % 64 == 0 and b > a for a, b in ranges)
    if S > 1:
        assert all(b - a >= tqmm._MIN_SPLIT_STEPS * 64 for a, b in ranges[:-1])
    col_tiles = F // (64 if gateup else 128)
    assert col_tiles * (S - 1) < 2 * tqmm._SMS
    if col_tiles >= tqmm._SMS:
        assert S == 1
    want = 0 if S == 1 else S * M * F * 4 * (2 if gateup else 1)
    assert tqmm.workspace_bytes(M, D, F, gateup, int4) == want
    launch = tqmm.qmm_launch(M, D, F, gateup, int4)
    assert launch['grid'] == [col_tiles, -(-M // 128), S]
    assert launch['product'].startswith('wgmma' if int4 else 'mma.sync')
    return ranges


@pytest.mark.parametrize('gateup', [False, True], ids=['int8', 'gateup'])
@pytest.mark.parametrize('D,F', SPLIT_DF)
@pytest.mark.parametrize('M', SPLIT_M)
def test_qmm_splits_cover_the_depth(M, D, F, gateup):
    """The INT8 bodies' splits (_check_splits)."""
    _check_splits(M, D, F, gateup, False)


@pytest.mark.parametrize('gateup', [False, True], ids=['int4', 'gateup4'])
@pytest.mark.parametrize('D,F', SPLIT_DF_INT4)
@pytest.mark.parametrize('M', SPLIT_M)
def test_qmm_int4_splits_cover_the_depth(M, D, F, gateup):
    """The INT4 bodies' splits (_check_splits) at shapes they take; a
    split's packed rows are whole 32-row steps of the (D/2, F) weight and
    cover it once."""
    assert tqmm.supports_int4(D // 2, F) and \
        tqmm.supports_gateup(D, 2 * F, M, 4)
    ranges = _check_splits(M, D, F, gateup, True)
    packed = [(a // 2, b // 2) for a, b in ranges]
    assert all(a % 32 == 0 and b % 32 == 0 for a, b in packed)
    assert packed[-1][1] == D // 2


def test_qmm_splits_depend_on_the_weight_alone(monkeypatch):
    """_splits reads the weight's (D, F) and the body, nothing of the rows,
    the device, the environment or the call. The decode shapes of the 1B
    model split: wqkv, wo, w_down and the INT8 gate-up; the INT4 gate-up's
    88 column tiles take the depth alone (one wave beats two on the INT4
    body's cost model); the lm_head's columns fill the card alone."""
    import inspect
    assert list(inspect.signature(tqmm._splits).parameters) == \
        ['D', 'F', 'gateup', 'int4']
    shapes = [(D, F, g, int4)
              for int4, df in ((False, SPLIT_DF), (True, SPLIT_DF_INT4))
              for D, F in df for g in (False, True)]
    before = [tqmm._splits(*s) for s in shapes]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setenv('CUDA_VISIBLE_DEVICES', '3')
    assert [tqmm._splits(*s) for s in reversed(shapes)] == before[::-1]
    for int4 in (False, True):
        for D, F in ((2048, 4096), (2048, 2048), (5632, 2048)):
            assert tqmm._splits(D, F, False, int4) > 1, (D, F, int4)
    assert tqmm._splits(2048, 5632, True) > 1
    assert tqmm._splits(2048, 5632, True, True) == 1
    assert tqmm._splits(2048, 32000) == tqmm._splits(2048, 32768) == 1


def test_qmm_cpu_wrappers_take_no_workspace():
    """On CPU tensors the wrappers run the plain versions, both bodies: no
    split, no workspace, no launch."""
    tqmm._workspaces.clear()
    x, w, scale, row, res = (torch.from_numpy(a)
                             for a in _qmm_case(128, 2048, 2048, seed=3))
    packed = tqmm.pack_int4_splithalf(w.clamp(-8, 7))
    for name in ('qmm_int8', 'qmm_int4', 'qmm_gateup', 'qmm_gateup_int4'):
        LAUNCHES[name] = 0
    qmm_int8(x, w, scale, torch.float32, row, res)
    tqmm.qmm_int4(x, packed, scale, torch.float32, row, res)
    qmm_gateup(x, w, scale, torch.float32, row)
    qmm_gateup(x, packed, scale, torch.float32, row)
    assert not tqmm._workspaces
    assert all(LAUNCHES[name] == 0 for name in (
        'qmm_int8', 'qmm_int4', 'qmm_gateup', 'qmm_gateup_int4'))


def _codes(rng, shape, dtype):
    if dtype == 'int8':
        return rng.integers(-128, 128, size=shape).astype(np.int8)
    return _bf16(rng.standard_normal(shape).astype(np.float32))


def _to_jax(a, dtype):
    return jnp.asarray(a) if dtype == 'int8' else jnp.asarray(a, jnp.bfloat16)


def _to_torch(a, dtype):
    t = torch.from_numpy(a.copy())
    return t if dtype == 'int8' else t.bfloat16()


def _same_bits(got, want, dtype):
    want = np.asarray(want if dtype == 'int8' else want.astype(jnp.float32))
    got = got.numpy() if dtype == 'int8' else got.float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('device_col', [False, True])
@pytest.mark.parametrize('dtype', ['int8', 'bfloat16'])
@pytest.mark.parametrize('n_arrays,B,CH,KV,Dh,col', [(4, 3, 5, 2, 128, 0),
                                                     (2, 2, 4, 1, 256, 3)])
def test_bank_write_vs_pallas(n_arrays, B, CH, KV, Dh, col, dtype, device_col):
    rng = np.random.default_rng(n_arrays + col)
    bufs = [_codes(rng, (B, CH, KV, Dh), dtype) for _ in range(n_arrays)]
    news = [_codes(rng, (B, 1, KV, Dh), dtype) for _ in range(n_arrays)]
    assert supports_bank(bufs[0].shape) and jbank.supports_bank(bufs[0].shape)
    want = jbank.bank_write_inplace(
        tuple(_to_jax(b, dtype) for b in bufs),
        tuple(_to_jax(n, dtype) for n in news),
        jnp.int32(col), interpret=True)
    t_bufs = [_to_torch(b, dtype) for b in bufs]
    before = dict(LAUNCHES)
    got = bank_write_inplace(
        Bank(t_bufs), [_to_torch(n, dtype) for n in news],
        torch.tensor([col], dtype=torch.int32) if device_col else col)
    assert LAUNCHES == before          # a CPU tensor launches nothing
    for g, t, w in zip(got, t_bufs, want):
        assert g is t                  # in place
        _same_bits(g, w, dtype)


def test_bank_write_into_views_of_one_buffer():
    """The burst's chunk buffers are column ranges of one (B, n, KV, Dh)
    buffer: a write into the view lands in the buffer."""
    rng = np.random.default_rng(0)
    whole = torch.from_numpy(_codes(rng, (3, 8, 2, 128), 'int8'))
    want = whole.clone()
    new = torch.from_numpy(_codes(rng, (3, 1, 2, 128), 'int8'))
    bank_write_inplace(Bank([whole[:, 4:8]]), [new],
                       torch.tensor([1], dtype=torch.int32))
    want[:, 5] = new[:, 0]
    assert torch.equal(whole, want)


@pytest.mark.parametrize('dtype', ['int8', 'bfloat16'])
@pytest.mark.parametrize('L,B,S,n,KV,Dh,pos', [
    (2, 3, 16, 4, 2, 128, [0, 12, 5]),
    (1, 4, 8, 8, 1, 128, [0, 0, 0, 0]),
    (3, 2, 32, 5, 1, 256, [27, 3])])
def test_window_write_vs_pallas(L, B, S, n, KV, Dh, pos, dtype):
    rng = np.random.default_rng(L + B + S)
    slabs = [_codes(rng, (L, B, S, KV, Dh), dtype) for _ in range(2)]
    news = [_codes(rng, (L, B, n, KV, Dh), dtype) for _ in range(2)]
    assert supports_dense(slabs[0].shape) and jwindow.supports_dense(slabs[0].shape)
    assert not supports_dense((L, B, S, KV)) \
        and not jwindow.supports_dense((L, B, S, KV))
    want = jwindow.window_write_inplace(
        tuple(_to_jax(s, dtype) for s in slabs),
        tuple(_to_jax(w, dtype) for w in news),
        jnp.asarray(pos, jnp.int32), interpret=True)
    t_slabs = [_to_torch(s, dtype) for s in slabs]
    got = window_write_inplace(
        t_slabs, [_to_torch(w, dtype) for w in news],
        torch.tensor(pos, dtype=torch.int32))
    for g, t, w in zip(got, t_slabs, want):
        assert g is t
        _same_bits(g, w, dtype)
