"""The port's blockwise training passes (ppq_tpu_torch.quantization.optim
.training) held against the JAX package, on the CPU.

The same small quantized graph lives in both packages: tiny_cnn (3 computing
ops, 2x3x16x16, 4 calibration batches) is quantized by `ppq_tpu`, and its
TQCs are carried into the port's graph of the same seeded model with
`ppq_tpu_torch.interop`. Block partition, block losses, step-0 gradients and
the passes' results are then compared. Adam turns a gradient near zero into
a full-size step, so trained weights drift apart element by element: the
tests compare gradients at step 0 and losses after training, not weights.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
# torch.optim.Adam imports torch._dynamo at its first step, and that import
# scans sys.modules: do it now, before tests/test_torch_interop.py plants a
# stand-in `onnx` module without a __spec__ in this process
import torch._dynamo  # noqa: F401

import ppq_tpu
import ppq_tpu_torch
from ppq_tpu.api import QuantizationSettingFactory as JaxSettings
from ppq_tpu.executor import compile as jax_compile
from ppq_tpu.executor.compile import CompiledGraph, _cfg_key
from ppq_tpu.kernels.floating import (pallas_floating_quant,
                                      pallas_floating_quant_bwd)
from ppq_tpu.quantization.optim import training as jax_training
from ppq_tpu.zoo import resnet18 as jax_resnet18
from ppq_tpu.zoo.vision import tiny_cnn as jax_tiny_cnn
from ppq_tpu_torch.api import QuantizationSettingFactory
from ppq_tpu_torch.executor.compile import CompiledGraph as TorchCompiledGraph
from ppq_tpu_torch.executor.compile import _cfg_key as torch_cfg_key
from ppq_tpu_torch.core import QuantizationStates
from ppq_tpu_torch.interop import (block_caches_from_numpy,
                                   block_caches_to_numpy,
                                   load_quantization_configs,
                                   quantization_configs_of)
from ppq_tpu_torch.ir import QuantableOperation
from ppq_tpu_torch.quantization.optim import training as torch_training
from ppq_tpu_torch.quantization.qfunction import fake_quant_np
from ppq_tpu_torch.zoo import resnet18 as torch_resnet18
from ppq_tpu_torch.zoo import tiny_cnn as torch_tiny_cnn

SHAPE = (2, 3, 16, 16)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One PyTorch thread for this module: with more, every convolution
    opens an OpenMP region whose workers spin at its barriers, and under a
    test run of several processes that stalls this module and takes the
    cores from the others. What is checked does not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _loader():
    rng = np.random.RandomState(5)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(4)]


_PAIRS = {}


def _pair(fp8=False):
    """tiny_cnn quantized by the JAX package (TPU_INT8, or TPU_FP8 with
    fp8_setting), and the port's graph of the same model carrying the same
    TQCs (weights come from the same seed). Both are built once per module
    and every caller gets its own copy: the tests train and rewrite them."""
    if fp8 not in _PAIRS:
        _PAIRS[fp8] = _build_pair(fp8)
    return copy.deepcopy(_PAIRS[fp8])


def _build_pair(fp8):
    platform = 'TPU_FP8' if fp8 else 'TPU_INT8'
    jg = jax_tiny_cnn(input_shape=SHAPE)
    ppq_tpu.quantize_graph(
        jg, _loader(), calib_steps=4,
        platform=ppq_tpu.TargetPlatform[platform],
        setting=JaxSettings.fp8_setting() if fp8 else None, verbose=False)
    tg = torch_tiny_cnn(input_shape=SHAPE)
    ppq_tpu_torch.quantize_graph(
        tg, _loader(), calib_steps=4,
        platform=ppq_tpu_torch.TargetPlatform[platform],
        setting=QuantizationSettingFactory.fp8_setting() if fp8 else None,
        verbose=False, device='cpu')
    load_quantization_configs(tg, quantization_configs_of(jg))
    # re-bake with the carried scales
    with torch_training._unbaked_parameters(tg):
        pass
    for name, var in jg.variables.items():
        if var.is_parameter:
            np.testing.assert_array_equal(np.asarray(var.value),
                                          np.asarray(tg.variables[name].value))
    return jg, tg


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5, 6))
def _kernel_floating_fake_quant(x, scale, exponent_bits, mantissa_bits,
                                quant_min, quant_max, channel_axis=None):
    """The JAX package's floating fake-quant as its Pallas kernels define
    it (interpret mode here): `pallas_floating_quant` forward,
    `pallas_floating_quant_bwd` backward. `jax.grad` of the package's jnp
    path rounds the cotangent to the fp8 grid instead, and the package has
    no scale gradient of its own: the scale gets none here."""
    return pallas_floating_quant(x, scale, exponent_bits, mantissa_bits,
                                 quant_min, quant_max, channel_axis)


def _kernel_ffq_fwd(x, scale, exponent_bits, mantissa_bits, quant_min,
                    quant_max, channel_axis):
    y = pallas_floating_quant(x, scale, exponent_bits, mantissa_bits,
                              quant_min, quant_max, channel_axis)
    return y, (x, scale)


def _kernel_ffq_bwd(exponent_bits, mantissa_bits, quant_min, quant_max,
                    channel_axis, residuals, g):
    x, scale = residuals
    return (pallas_floating_quant_bwd(x, g, scale, quant_min, quant_max),
            jnp.zeros_like(jnp.asarray(scale, jnp.float32)))


_kernel_floating_fake_quant.defvjp(_kernel_ffq_fwd, _kernel_ffq_bwd)


def _snr(pred, real):
    pred, real = np.asarray(pred, np.float64), np.asarray(real, np.float64)
    return float(((pred - real) ** 2).sum() / (real ** 2).sum())


def _block_signature(blocks):
    return [([op.name for op in b.rps], b.input_names, b.output_names)
            for b in blocks]


@pytest.mark.parametrize('block_size', [1, 2, 4])
def test_identical_block_partition(block_size):
    jg, tg = _pair()
    assert _block_signature(jax_training.BlockBuilder(jg).build(block_size)) \
        == _block_signature(torch_training.BlockBuilder(tg).build(block_size))


def test_identical_block_partition_resnet18():
    jb = jax_training.BlockBuilder(jax_resnet18(input_shape=[1, 3, 64, 64]))
    tb = torch_training.BlockBuilder(torch_resnet18(input_shape=[1, 3, 64, 64]))
    assert _block_signature(jb.build(4, only_quantable=False)) \
        == _block_signature(tb.build(4, only_quantable=False))


def test_block_losses_and_step0_gradients_vs_jax():
    """Per block, on the JAX package's cached inputs and targets: the block
    loss before training (rtol 1e-4), and the gradient of the first step's
    loss in every weight, bias, scale and offset (rtol 1e-3 of each
    gradient's largest element) against jax.grad through the compiled
    block."""
    jg, tg = _pair()
    loader = _loader()
    executor = ppq_tpu_torch.TorchExecutor(tg, device='cpu')
    jpass = jax_training.LearnedStepSizePass(block_size=2, calib_steps=4)
    tpass = torch_training.LearnedStepSizePass(block_size=2, calib_steps=4)
    jblocks = jax_training.BlockBuilder(jg).build(2)
    tblocks = torch_training.BlockBuilder(tg).build(2)
    compared = 0
    with jax_training._unbaked_parameters(jg), \
            torch_training._unbaked_parameters(tg):
        jqt, jfp = jpass.collect_caches(jg, jblocks, loader, None)
        tqt, tfp = tpass.collect_caches(tg, tblocks, loader, None, executor)
        # the port's own caches: the graph input exactly; later values to
        # one quantization step (XLA and oneDNN sum in other orders)
        for name in jqt[0]:
            np.testing.assert_allclose(tqt[0][name].numpy(), jqt[0][name],
                                       atol=0.05)
        for name in jfp[0]:
            np.testing.assert_allclose(tfp[0][name].numpy(), jfp[0][name],
                                       rtol=1e-4, atol=1e-5)
        assert [sorted(b) for b in block_caches_to_numpy(tqt)] \
            == [sorted(b) for b in jqt]
        tqt = block_caches_from_numpy(jqt, 'cpu')
        tfp = block_caches_from_numpy(jfp, 'cpu')
        for jb, tb in zip(jblocks, tblocks):
            cg = CompiledGraph(jg, op_span=jb.rps, input_names=jb.input_names,
                               output_names=jb.output_names)
            fwd = cg.build_trainable_forward()
            p0, q0 = cg.init_params(), cg.init_qparams()
            want_loss = jpass.block_loss(fwd, p0, q0, jb, jqt, jfp)

            def loss_fn(p, q):
                outs = fwd(p, q, {n: jnp.asarray(jqt[0][n])
                                  for n in jb.input_names})
                return sum(jnp.mean((o - jfp[0][n]) ** 2)
                           for n, o in zip(jb.output_names, outs))

            gp, gq = jax.grad(loss_fn, argnums=(0, 1))(p0, q0)
            tcg = TorchCompiledGraph(tg, op_span=tb.rps,
                                     input_names=tb.input_names,
                                     output_names=tb.output_names,
                                     device='cpu')
            tfwd = tcg.build_trainable_forward()
            params = {k: v.clone().requires_grad_(True)
                      for k, v in tcg.init_params().items()}
            qparams = {k: {kk: vv.clone().requires_grad_(True)
                           for kk, vv in v.items()}
                       for k, v in tcg.init_qparams().items()}
            assert sorted(params) == sorted(p0)
            got_loss = tpass.block_loss(tfwd, params, qparams, tb, tqt, tfp)
            np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
            outs = tfwd(params, qparams, {n: tqt[0][n]
                                          for n in tb.input_names})
            sum(torch.mean((o - tfp[0][n]) ** 2)
                for n, o in zip(tb.output_names, outs)).backward()

            def close(mine, theirs):
                theirs = np.asarray(theirs)
                mine = (np.zeros_like(theirs) if mine is None
                        else mine.numpy())
                assert mine.shape == theirs.shape
                np.testing.assert_allclose(
                    mine, theirs, rtol=1e-3,
                    atol=1e-3 * np.abs(theirs).max())

            for name, value in params.items():
                close(value.grad, gp[name])
                compared += 1
            roots = set()
            for jop, top in zip(jb.rps, tb.rps):
                if not hasattr(jop, 'config'):
                    continue
                for jc, tc in zip(jop.config, top.config):
                    key = _cfg_key(jc.dominated_by)
                    tkey = torch_cfg_key(tc.dominated_by)
                    assert (key in gq) == (tkey in qparams)
                    if key in gq and key not in roots:
                        roots.add(key)
                        close(qparams[tkey]['scale'].grad, gq[key]['scale'])
                        close(qparams[tkey]['offset'].grad,
                              gq[key]['offset'])
                        compared += 2
            assert len(roots) == len(q0) == len(qparams)
    assert compared > 20


def test_fp8_block_losses_and_step0_gradients_vs_jax(monkeypatch):
    """The TPU_FP8 graph, per block, on the JAX package's cached inputs and
    targets: the block loss before training (rtol 1e-4) and the step-0
    gradient of every weight and bias (rtol 1e-3 of each gradient's largest
    element), the JAX block differentiated through its Pallas floating
    kernels (forward and STE backward, interpret mode)."""
    monkeypatch.setattr(jax_compile, 'floating_fake_quant',
                        _kernel_floating_fake_quant)
    jg, tg = _pair(fp8=True)
    loader = _loader()
    executor = ppq_tpu_torch.TorchExecutor(tg, device='cpu')
    kw = dict(block_size=2, calib_steps=4, is_scale_trainable=False)
    jpass = jax_training.LearnedStepSizePass(**kw)
    tpass = torch_training.LearnedStepSizePass(**kw)
    jblocks = jax_training.BlockBuilder(jg).build(2)
    tblocks = torch_training.BlockBuilder(tg).build(2)
    compared = floating_sites = 0
    with jax_training._unbaked_parameters(jg), \
            torch_training._unbaked_parameters(tg):
        jqt, jfp = jpass.collect_caches(jg, jblocks, loader, None)
        tqt = block_caches_from_numpy(jqt, 'cpu')
        tfp = block_caches_from_numpy(jfp, 'cpu')
        for jb, tb in zip(jblocks, tblocks):
            cg = CompiledGraph(jg, op_span=jb.rps, input_names=jb.input_names,
                               output_names=jb.output_names)
            fwd = cg.build_trainable_forward()
            p0, q0 = cg.init_params(), cg.init_qparams()
            want_loss = jpass.block_loss(fwd, p0, q0, jb, jqt, jfp)

            def loss_fn(p):
                outs = fwd(p, q0, {n: jnp.asarray(jqt[0][n])
                                   for n in jb.input_names})
                return sum(jnp.mean((o - jfp[0][n]) ** 2)
                           for n, o in zip(jb.output_names, outs))

            gp = jax.grad(loss_fn)(p0)
            tcg = TorchCompiledGraph(tg, op_span=tb.rps,
                                     input_names=tb.input_names,
                                     output_names=tb.output_names,
                                     device='cpu')
            tfwd = tcg.build_trainable_forward()
            qparams = tcg.init_qparams()
            floating_sites += len({
                torch_cfg_key(tc.dominated_by) for top in tb.rps
                if hasattr(top, 'config') for tc in top.config
                if torch_cfg_key(tc.dominated_by) in qparams
                and tc.dominated_by.policy.floating})
            params = {k: v.clone().requires_grad_(True)
                      for k, v in tcg.init_params().items()}
            assert sorted(params) == sorted(p0)
            np.testing.assert_allclose(
                tpass.block_loss(tfwd, params, qparams, tb, tqt, tfp),
                want_loss, rtol=1e-4)
            outs = tfwd(params, qparams, {n: tqt[0][n]
                                          for n in tb.input_names})
            sum(torch.mean((o - tfp[0][n]) ** 2)
                for n, o in zip(tb.output_names, outs)).backward()
            for name, value in params.items():
                theirs = np.asarray(gp[name])
                assert np.abs(theirs).max() > 0
                np.testing.assert_allclose(
                    value.grad.numpy(), theirs, rtol=1e-3,
                    atol=1e-3 * np.abs(theirs).max())
                compared += 1
    assert compared == 6 and floating_sites >= 6


def test_fp8_lsq_same_decisions_and_same_snr_movement(monkeypatch):
    """LSQ with frozen scales over the TPU_FP8 graph in both packages (the
    JAX package through its Pallas floating kernels), Adam at lr 1e-4 for
    20 steps on the same cached block inputs: the same pre-loss (rtol
    1e-4), the same accept / roll back decisions, the same post-loss and
    the same change of the output's SNR against the fp32 model (both rtol
    1e-2; measured 6e-8: on the coarse E4M3 grid the two trajectories do
    not part as the INT8 ones do). Both improve it, 3.1e-3 -> 1.4e-3."""
    monkeypatch.setattr(jax_compile, 'floating_fake_quant',
                        _kernel_floating_fake_quant)
    jg, tg = _pair(fp8=True)
    loader = _loader()
    fp32 = ppq_tpu_torch.TorchExecutor(torch_tiny_cnn(input_shape=SHAPE),
                                       device='cpu')
    refs = [fp32.forward(x)[0].numpy() for x in loader]

    def snr_jax():
        executor = ppq_tpu.TPUExecutor(jg)
        return np.mean([_snr(np.asarray(executor.forward(x)[0]), r)
                        for x, r in zip(loader, refs)])

    def snr_torch():
        executor = ppq_tpu_torch.TorchExecutor(tg, device='cpu')
        return np.mean([_snr(executor.forward(x)[0].numpy(), r)
                        for x, r in zip(loader, refs)])

    before = snr_jax(), snr_torch()
    np.testing.assert_allclose(before[1], before[0], rtol=1e-3)
    kw = dict(block_size=2, steps=20, lr=1e-4, calib_steps=4,
              is_scale_trainable=False)
    seen = _record_block_losses(monkeypatch)
    _share_caches(monkeypatch)
    ppq_tpu.api.manop(jg, jax_training.LearnedStepSizePass(**kw),
                      calib_dataloader=loader, verbose=False)
    tpass = torch_training.LearnedStepSizePass(**kw)
    ppq_tpu_torch.manop(tg, tpass, calib_dataloader=loader, verbose=False,
                        device='cpu')
    assert len(seen) == 2 * len(tpass.history) == 4
    for (pre, post), mine in zip(zip(seen[0::2], seen[1::2]), tpass.history):
        np.testing.assert_allclose(mine['pre_loss'], pre, rtol=1e-4)
        assert mine['accepted'] == (post < pre)
        np.testing.assert_allclose(mine['post_loss'], post, rtol=1e-2)
    assert all(h['accepted'] for h in tpass.history)
    after = snr_jax(), snr_torch()
    assert after[0] < before[0] and after[1] < before[1], (before, after)
    np.testing.assert_allclose(after[1] / before[1], after[0] / before[0],
                               rtol=1e-2)


def _record_block_losses(monkeypatch):
    """The JAX pass logs its losses; record what block_loss returns."""
    seen = []
    original = jax_training.TrainingBasedPass.block_loss

    def recording(*args, **kwargs):
        seen.append(original(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(jax_training.TrainingBasedPass, 'block_loss',
                        staticmethod(recording))
    return seen


def _share_caches(monkeypatch):
    """Hand the port's pass the JAX pass's block caches (carried as numpy),
    so that both train on the same block inputs and targets: their own
    caches differ by activation codes that flip at rounding ties, and the
    JAX package takes every block's inputs once, before any block is
    trained, where the port takes a block's inputs just before it trains
    that block."""
    taken = {}
    original = jax_training.TrainingBasedPass.collect_caches

    def recording(self, *args, **kwargs):
        taken['caches'] = original(self, *args, **kwargs)
        return taken['caches']

    def carried(which):
        def collect(graph, blocks, batches, executor):
            return block_caches_from_numpy(taken['caches'][which],
                                           executor.device)
        return staticmethod(collect)

    monkeypatch.setattr(jax_training.TrainingBasedPass, 'collect_caches',
                        recording)
    monkeypatch.setattr(torch_training.TrainingBasedPass, 'collect_inputs',
                        carried(0))
    monkeypatch.setattr(torch_training.TrainingBasedPass, 'collect_targets',
                        carried(1))


@pytest.mark.parametrize('steps,rtol', [(2, 1e-2), (20, 0.5)])
def test_lsq_same_settings_same_decisions(monkeypatch, steps, rtol):
    """Adam at lr 1e-4 over every block in both packages, on the same cached
    block inputs: the same pre-loss (rtol 1e-4), and both accept or both
    roll back. The first steps of the two trajectories coincide (post-loss
    after 2 steps: rtol 1e-2). Later they part: on activations of 32 to 2048
    values one code that flips at a rounding tie moves a step's loss by
    20 %, and summation order decides the flip. After 20 steps both have
    improved every block and their post-losses lie within a factor 1.5."""
    jg, tg = _pair()
    loader = _loader()
    kw = dict(block_size=2, steps=steps, lr=1e-4, calib_steps=4)
    seen = _record_block_losses(monkeypatch)
    _share_caches(monkeypatch)
    ppq_tpu.api.manop(jg, jax_training.LearnedStepSizePass(**kw),
                      calib_dataloader=loader, verbose=False)
    tpass = torch_training.LearnedStepSizePass(**kw)
    ppq_tpu_torch.manop(tg, tpass, calib_dataloader=loader, verbose=False,
                        device='cpu')
    assert len(seen) == 2 * len(tpass.history) == 4
    for (pre, post), mine in zip(zip(seen[0::2], seen[1::2]), tpass.history):
        np.testing.assert_allclose(mine['pre_loss'], pre, rtol=1e-4)
        assert mine['accepted'] == (post < pre)
        np.testing.assert_allclose(mine['post_loss'], post, rtol=rtol)
    if steps == 20:
        assert all(h['accepted'] for h in tpass.history)
    x = loader[0]
    y_jax = np.asarray(ppq_tpu.TPUExecutor(jg).forward(x)[0])
    y_torch = ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(x)[0].numpy()
    assert _snr(y_torch, y_jax) < 1e-3


def test_lsq_rolls_back_when_training_worsens_the_block(monkeypatch):
    """A step size large enough to wreck the block: both packages roll
    back, and the port leaves weights, shadows and scales untouched."""
    jg, tg = _pair()
    loader = _loader()
    kw = dict(block_size=4, steps=4, lr=0.5, calib_steps=2)
    seen = _record_block_losses(monkeypatch)
    ppq_tpu.api.manop(jg, jax_training.LearnedStepSizePass(**kw),
                      calib_dataloader=loader, verbose=False)
    before = {n: np.array(v.value, copy=True) for n, v in tg.variables.items()
              if v.is_parameter}
    cfgs = quantization_configs_of(tg)
    tpass = torch_training.LearnedStepSizePass(**kw)
    ppq_tpu_torch.manop(tg, tpass, calib_dataloader=loader, verbose=False,
                        device='cpu')
    assert [h['accepted'] for h in tpass.history] == [False] \
        == [post < pre for pre, post in zip(seen[0::2], seen[1::2])]
    for name, value in before.items():
        np.testing.assert_array_equal(tg.variables[name].value, value)
    after = quantization_configs_of(tg)
    for key, entry in cfgs.items():
        if entry['scale'] is not None:
            np.testing.assert_array_equal(after[key]['scale'], entry['scale'])
            np.testing.assert_array_equal(after[key]['offset'], entry['offset'])


@pytest.mark.parametrize('block_size', [4, 2])
def test_bias_correction_matches_jax(block_size):
    """The corrections themselves: every bias after the pass, in both
    packages, atol 1e-5. With block_size 2 the last block (the Gemm) starts
    from cached activations of 32 values a batch, where the two packages
    differ by single codes that flipped at a rounding tie (one step, 0.038);
    one flip moves that block's correction by up to 1e-2, so the Gemm bias is
    held to 2e-2 there."""
    jg, tg = _pair()
    loader = _loader()
    before = {n: np.array(v, copy=True) for op in tg.operations.values()
              if isinstance(op, QuantableOperation)
              for n, v in op._fp32_params.items()}
    ppq_tpu.api.manop(
        jg, jax_training.BiasCorrectionPass(block_size=block_size, steps=4),
        calib_dataloader=loader, verbose=False)
    tpass = torch_training.BiasCorrectionPass(block_size=block_size, steps=4)
    ppq_tpu_torch.manop(tg, tpass, calib_dataloader=loader, verbose=False,
                        device='cpu')
    assert len(tpass.history) == (1 if block_size == 4 else 2)
    assert all(h['accepted'] for h in tpass.history)
    moved = 0
    for name, op in tg.operations.items():
        if op.type in ('Conv', 'Gemm'):
            bias = op.inputs[2].name
            mine = op._fp32_params[bias]
            theirs = jg.operations[name]._fp32_params[bias]
            loose = block_size == 2 and op.type == 'Gemm'
            np.testing.assert_allclose(mine, theirs, rtol=0,
                                       atol=2e-2 if loose else 1e-5)
            moved += int(not np.array_equal(mine, before[bias]))
    assert moved == 3


@pytest.mark.parametrize('which', ['AdaroundPass', 'RoundTuningPass'])
def test_round_tuning_objective_and_step0_gradient_vs_jax(which):
    """Per block, on the JAX package's cached inputs and targets, with the
    weights soft-rounded: the initial rounding variables v (equal), the
    first step's objective (block MSE + regularizer at beta 20; rtol 1e-4)
    and its gradient in every v (rtol 1e-3 of each gradient's largest
    element) against jax.grad through the JAX pass's compiled block."""
    jg, tg = _pair()
    loader = _loader()
    executor = ppq_tpu_torch.TorchExecutor(tg, device='cpu')
    jpass = getattr(jax_training, which)(block_size=2, calib_steps=4)
    tpass = getattr(torch_training, which)(block_size=2, calib_steps=4)
    assert (jpass.steps, jpass.lr, jpass.reg_gamma, jpass.beta_anneal) \
        == (tpass.steps, tpass.lr, tpass.reg_gamma, tpass.beta_anneal)
    beta = tpass.beta_anneal[0]
    jblocks = jax_training.BlockBuilder(jg).build(2)
    tblocks = torch_training.BlockBuilder(tg).build(2)
    compared = 0
    with jax_training._unbaked_parameters(jg), \
            torch_training._unbaked_parameters(tg):
        jqt, jfp = jpass.collect_caches(jg, jblocks, loader, None)
        tqt = block_caches_from_numpy(jqt, 'cpu')
        tfp = block_caches_from_numpy(jfp, 'cpu')
        for jb, tb in zip(jblocks, tblocks):
            jtargets = jpass._weight_targets(jb)
            ttargets = tpass._weight_targets(tb)
            assert [(op.name, i) for op, i in jtargets] \
                == [(op.name, i) for op, i in ttargets] and ttargets
            winfo, saved = tpass._soft_round_setup(ttargets, 'cpu')
            # the JAX pass's set-up and objective, as its _tune_block
            # builds them (they are closures there)
            jinfo = {}
            for op, idx in jtargets:
                cfg = op.config.input_quantization_config[idx]
                saved.append((cfg, cfg.state))
                cfg.state = ppq_tpu.core.QuantizationStates.FP32
                w0 = np.asarray(op.inputs[idx].value, np.float32)
                shape = [1] * w0.ndim
                shape[cfg.channel_axis] = -1
                s_b = np.asarray(cfg.scale, np.float32).reshape(shape)
                floor = np.floor(w0 / s_b)
                jinfo[op.inputs[idx].name] = dict(
                    floor=jnp.asarray(floor), s=jnp.asarray(s_b),
                    qmin=float(cfg.quant_min), qmax=float(cfg.quant_max),
                    v0=jnp.asarray(jpass._init_v(w0 / s_b - floor)))
            try:
                cg = CompiledGraph(jg, op_span=jb.rps,
                                   input_names=jb.input_names,
                                   output_names=jb.output_names)
                fwd = cg.build_trainable_forward()
                p0, q0 = cg.init_params(), cg.init_qparams()

                def objective(vs):
                    p = dict(p0)
                    for name, v in vs.items():
                        wi = jinfo[name]
                        p[name] = jnp.clip(wi['floor'] + jpass._h(v),
                                           wi['qmin'], wi['qmax']) * wi['s']
                    outs = fwd(p, q0, {n: jnp.asarray(jqt[0][n])
                                       for n in jb.input_names})
                    loss = sum(jnp.mean((o - jfp[0][n]) ** 2)
                               for n, o in zip(jb.output_names, outs))
                    reg = sum(jnp.sum(1.0 - jnp.abs(2.0 * jpass._h(v) - 1.0)
                                      ** beta) for v in vs.values())
                    return loss + jpass.reg_gamma * 1e-3 * reg

                vs = {n: wi['v0'] for n, wi in jinfo.items()}
                want, grads = jax.value_and_grad(objective)(vs)
                tcg = TorchCompiledGraph(tg, op_span=tb.rps,
                                         input_names=tb.input_names,
                                         output_names=tb.output_names,
                                         device='cpu')
                got = tpass._objective(
                    tcg.build_trainable_forward(), tcg.init_params(),
                    tcg.init_qparams(), winfo, tb, tqt[0], tfp[0],
                    torch.tensor(beta, dtype=torch.float32))
                got.backward()
                np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
                assert sorted(winfo) == sorted(jinfo)
                for name, wi in winfo.items():
                    np.testing.assert_array_equal(
                        wi['v'].detach().numpy(), np.asarray(vs[name]))
                    theirs = np.asarray(grads[name])
                    assert np.abs(theirs).max() > 0
                    np.testing.assert_allclose(
                        wi['v'].grad.numpy(), theirs, rtol=1e-3,
                        atol=1e-3 * np.abs(theirs).max())
                    compared += 1
            finally:
                for cfg, state in saved:
                    cfg.state = state
    assert compared == 3


def test_round_tuning_same_rounding_decisions_as_jax(monkeypatch):
    """RoundTuningPass with the same settings on the same cached block
    inputs in both packages: the tuned weights agree in all but 1 % of
    their elements (a v that ends within Adam's drift of h = 0.5 may fall
    either way; measured: none of 2896 differ), every difference is one
    quantization step, and the pass moved some weights."""
    jg, tg = _pair()
    loader = _loader()
    before = {n: np.array(v.value, copy=True) for n, v in tg.variables.items()
              if v.is_parameter}
    kw = dict(block_size=2, steps=20, calib_steps=4)
    _share_caches(monkeypatch)
    ppq_tpu.api.manop(jg, jax_training.RoundTuningPass(**kw),
                      calib_dataloader=loader, verbose=False)
    ppq_tpu_torch.manop(tg, torch_training.RoundTuningPass(**kw),
                        calib_dataloader=loader, verbose=False, device='cpu')
    total = differ = moved = 0
    for name, op in tg.operations.items():
        if isinstance(op, QuantableOperation) and op.type in ('Conv', 'Gemm'):
            cfg = op.config.input_quantization_config[1]
            mine = np.asarray(op.inputs[1].value)
            moved += int((mine != before[op.inputs[1].name]).sum())
            theirs = np.asarray(jg.operations[name].inputs[1].value)
            shape = [1] * mine.ndim
            shape[cfg.channel_axis] = -1
            steps = (mine - theirs) / np.asarray(cfg.scale).reshape(shape)
            assert np.all(np.abs(steps) <= 1.0001)
            differ += int((steps != 0).sum())
            total += mine.size
    assert total > 1000 and differ <= 0.01 * total, (differ, total)
    assert moved > 0


@pytest.mark.parametrize('which', ['AdaroundPass', 'RoundTuningPass'])
def test_round_tuning_keeps_weights_on_grid(which):
    jg, tg = _pair()
    before = {n: np.array(v.value, copy=True) for n, v in tg.variables.items()
              if v.is_parameter}
    tpass = getattr(torch_training, which)(block_size=2, steps=20,
                                           calib_steps=4)
    ppq_tpu_torch.manop(tg, tpass, calib_dataloader=_loader(), verbose=False,
                        device='cpu')
    checked = changed = 0
    for op in tg.operations.values():
        if isinstance(op, QuantableOperation) and op.type in ('Conv', 'Gemm'):
            cfg = op.config.input_quantization_config[1]
            assert cfg.state == QuantizationStates.BAKED
            w = np.asarray(op.inputs[1].value)
            shape = [1] * w.ndim
            shape[cfg.channel_axis] = -1
            q = w / np.asarray(cfg.scale).reshape(shape)
            np.testing.assert_allclose(q, np.round(q), atol=1e-4)
            assert np.abs(q).max() <= 128
            # a rounding direction moves a weight by at most one step
            step = np.asarray(cfg.scale).reshape(shape)
            assert np.all(np.abs(w - before[op.inputs[1].name])
                          <= step * 1.0001)
            changed += int(not np.array_equal(w, before[op.inputs[1].name]))
            checked += 1
    assert checked == 3 and changed >= 1
    y = ppq_tpu_torch.TorchExecutor(tg, device='cpu').forward(_loader()[0])[0]
    assert torch.isfinite(y).all()


def test_finetune_after_baking_keeps_fp32_shadows_in_step():
    """Training passes applied after ParameterBakingPass: what the IR holds
    is the baking of the trained shadows, so an exporter that re-quantizes
    the shadows reproduces the simulation."""
    _, tg = _pair()
    loader = _loader()
    shadows = {(op.name, n): np.array(v, copy=True)
               for op in tg.operations.values()
               if isinstance(op, QuantableOperation)
               for n, v in op._fp32_params.items()}
    ppq_tpu_torch.manop(
        tg, [torch_training.BiasCorrectionPass(steps=4),
             torch_training.LearnedStepSizePass(block_size=2, steps=20,
                                                lr=1e-4, calib_steps=4)],
        calib_dataloader=loader, verbose=False, device='cpu')
    trained = 0
    for op in tg.operations.values():
        if not isinstance(op, QuantableOperation):
            continue
        for var, cfg in zip(op.inputs, op.config.input_quantization_config):
            if not var.is_parameter:
                continue
            assert cfg.state in (QuantizationStates.BAKED,
                                 QuantizationStates.PASSIVE_BAKED)
            shadow = op._fp32_params[var.name]
            live = cfg.copy()
            live.state = (QuantizationStates.ACTIVATED
                          if cfg.state == QuantizationStates.BAKED
                          else QuantizationStates.PASSIVE)
            np.testing.assert_array_equal(np.asarray(var.value),
                                          fake_quant_np(shadow, live))
            trained += int(not np.array_equal(shadow,
                                              shadows[(op.name, var.name)]))
    assert trained >= 4


def test_lsq_through_quantize_graph_setting():
    """`setting.lsq_optimization = True` runs LSQ inside quantize_graph and
    does not worsen the output against fp32; the JAX package under the same
    setting moves its SNR the same way, and the two SNRs after LSQ lie
    within a factor 1.5 (each package trains on its own caches, whose
    codes differ at rounding ties)."""
    loader = _loader()

    def jax_snr(lsq):
        graph = jax_tiny_cnn(input_shape=SHAPE)
        setting = JaxSettings.default_setting()
        setting.lsq_optimization = lsq
        setting.lsq_optimization_setting.steps = 20
        setting.lsq_optimization_setting.block_size = 2
        setting.lsq_optimization_setting.lr = 1e-4
        ppq_tpu.quantize_graph(graph, loader, calib_steps=4, setting=setting,
                               platform=ppq_tpu.TargetPlatform.TPU_INT8,
                               verbose=False)
        executor = ppq_tpu.TPUExecutor(graph)
        return np.mean([_snr(np.asarray(executor.forward(x)[0]), r)
                        for x, r in zip(loader, refs)])

    def quantized(lsq):
        graph = torch_tiny_cnn(input_shape=SHAPE)
        setting = QuantizationSettingFactory.default_setting()
        setting.lsq_optimization = lsq
        setting.lsq_optimization_setting.steps = 20
        setting.lsq_optimization_setting.block_size = 2
        setting.lsq_optimization_setting.lr = 1e-4
        ppq_tpu_torch.quantize_graph(
            graph, loader, calib_steps=4, setting=setting, verbose=False,
            platform=ppq_tpu_torch.TargetPlatform.TPU_INT8, device='cpu')
        executor = ppq_tpu_torch.TorchExecutor(graph, device='cpu')
        outs = [executor.forward(x)[0].numpy() for x in loader]
        with ppq_tpu_torch.DEQUANTIZE_GRAPH(graph):
            refs = [executor.forward(x)[0].numpy() for x in loader]
        return graph, outs, refs

    _, base, base_refs = quantized(False)
    graph, tuned, tuned_refs = quantized(True)
    fp32 = ppq_tpu_torch.TorchExecutor(torch_tiny_cnn(input_shape=SHAPE),
                                       device='cpu')
    refs = [fp32.forward(x)[0].numpy() for x in loader]
    pre = np.mean([_snr(y, r) for y, r in zip(base, refs)])
    post = np.mean([_snr(y, r) for y, r in zip(tuned, refs)])
    assert post <= pre * 1.05, (pre, post)
    assert not np.array_equal(base[0], tuned[0])
    jax_pre, jax_post = jax_snr(False), jax_snr(True)
    # the JAX package calibrates on its compiled path here: 5 % apart
    np.testing.assert_allclose(pre, jax_pre, rtol=0.1)
    assert (jax_post < jax_pre) == (post < pre), (jax_pre, jax_post, pre, post)
    assert 1 / 1.5 < post / jax_post < 1.5, (jax_post, post)


def test_training_passes_need_a_device(monkeypatch):
    """Entry points train on the card; without one and without a named
    device they raise."""
    _, tg = _pair()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        ppq_tpu_torch.manop(tg, torch_training.LearnedStepSizePass(steps=1),
                            calib_dataloader=_loader(), verbose=False)
    with pytest.raises(ValueError, match='executor'):
        torch_training.LearnedStepSizePass(steps=1).optimize(
            tg, dataloader=_loader())


def test_forward_with_gradient_and_parameter_overrides():
    """forward_with_gradient records the graph back to override tensors and
    to the input; the plain forward records nothing; a parameter written by
    a pass is seen by the next forward of the same executor."""
    _, tg = _pair()
    with torch_training._unbaked_parameters(tg):
        executor = ppq_tpu_torch.TorchExecutor(tg, device='cpu')
        x = torch.tensor(_loader()[0], requires_grad=True)
        conv = next(op for op in tg.operations.values() if op.type == 'Conv')
        w_name = conv.inputs[1].name
        w = torch.tensor(np.asarray(tg.variables[w_name].value),
                         requires_grad=True)
        plain = executor.forward(x)[0]
        assert plain.grad_fn is None
        y = executor.forward_with_gradient(x, parameters={w_name: w})[0]
        assert torch.equal(y.detach(), plain)
        y.square().mean().backward()
        assert w.grad is not None and w.grad.abs().max() > 0
        assert x.grad is not None and x.grad.shape == x.shape
        # an override replaces the IR's value for that call only
        y2 = executor.forward_with_gradient(x, parameters={w_name: w * 0})[0]
        assert not torch.equal(y2.detach(), plain)
        assert torch.equal(executor.forward(x)[0], plain)
        torch_training._sync_fp32_shadow(
            tg, w_name, np.zeros_like(tg.variables[w_name].value))
        assert torch.equal(executor.forward(x)[0], y2.detach())
