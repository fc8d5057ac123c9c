"""Head-to-head parity harness: ppq_tpu_torch vs the reference PPQ
implementation (a copy of ppq_tpu/interop/reference_parity.py, pointed at
the port's API; the port runs on the CPU here, as the reference does).

The reference proves "simulator == deployment" by re-running its exported
QDQ graph under onnxruntime (its tests/test_onnxruntime.py).
No onnxruntime exists in this image — instead we run the reference
FRAMEWORK ITSELF (CPU torch) on the same ONNX file with the same
calibration tensors and compare:

  * per-tensor activation scales + per-channel weight scales (keyed by
    variable name — both parsers preserve ONNX names);
  * the INT8-simulated model outputs (SNR between the two simulators);
  * fp32 outputs (parser/executor parity, quantization aside).

MUST run in a fresh subprocess: the reference's generated
ppl_caffe_pb2.py needs PROTOCOL_BUFFERS_PYTHON_IMPLEMENTATION=python
before `google.protobuf` first loads, and the two frameworks' torch state
is cleanest isolated. tests/test_torch_interop_shim.py is the subprocess wrapper; it
skips without a PPQ checkout at PPQ_REFERENCE_ROOT.

Usage:  python -m ppq_tpu_torch.interop.reference_parity <out.json> \
            [--model tiny_cnn|resnet18] [--observer minmax|kl|mse]
"""

import os
import sys

# BEFORE protobuf loads anywhere: the reference's pb2 needs the pure-
# python implementation.
os.environ.setdefault('PROTOCOL_BUFFERS_PYTHON_IMPLEMENTATION', 'python')

import argparse        # noqa: E402
import json            # noqa: E402
import tempfile        # noqa: E402

import numpy as np     # noqa: E402


def build_model(name: str, batch: int):
    """Parity models are built here with torch-style conventions (Gemm
    transB=1, weight [out,in]) — the reference quantizer hardcodes Gemm
    channel_axis=0 for that layout (PPLQuantizer.py:46-52)."""
    from ppq_tpu_torch.zoo.builder import NetBuilder
    if name == 'resnet18':
        # the real zoo topology at full 224x224 resolution — the r4
        # harness only exercised 2-3-conv toys at 16x16
        from ppq_tpu_torch.zoo.vision import resnet18
        g = resnet18(num_classes=10, input_shape=[batch, 3, 224, 224],
                     seed=23)
        # the reference quantizer hardcodes Gemm channel_axis=0 for the
        # torch [out, in] layout (PPLQuantizer.py:46-52); the zoo builder
        # emits transB=0 [in, out] — transpose the head weight in place
        for op in g.operations.values():
            if op.type == 'Gemm' and op.attributes.get('transB', 0) == 0:
                w = op.inputs[1]
                w.value = np.ascontiguousarray(np.asarray(w.value).T)
                op.attributes['transB'] = 1
        return g, (batch, 3, 224, 224)
    b = NetBuilder(name, seed=23)
    if name == 'convnet':
        x = b.input('x', [batch, 3, 16, 16])
        h = b.conv(x, 3, 8, k=3, pad=1, bias=True)
        h = b.op('Relu', [h])
        h = b.op('MaxPool', [h], kernel_shape=[2, 2], strides=[2, 2],
                 pads=[0, 0, 0, 0])
        h = b.conv(h, 8, 12, k=3, pad=1, bias=True)
        h = b.op('Relu', [h])
        h = b.op('GlobalAveragePool', [h])
        h = b.op('Flatten', [h], axis=1)
        y = b.op('Gemm', [h, b.param(b.rng.randn(10, 12) * 0.3),
                          b.param(b.rng.randn(10) * 0.01)],
                 alpha=1.0, beta=1.0, transA=0, transB=1)
        b.output(y)
        return b.g, (batch, 3, 16, 16)
    if name == 'resblock':
        x = b.input('x', [batch, 4, 16, 16])
        h = b.conv(x, 4, 8, k=3, pad=1, bias=True)
        h = b.op('Relu', [h])
        r = b.conv(h, 8, 8, k=3, pad=1, bias=True)
        r = b.op('Relu', [r])
        r = b.conv(r, 8, 8, k=3, pad=1, bias=True)
        s = b.op('Add', [r, h])
        s = b.op('Relu', [s])
        s = b.op('GlobalAveragePool', [s])
        s = b.op('Flatten', [s], axis=1)
        y = b.op('Gemm', [s, b.param(b.rng.randn(10, 8) * 0.3),
                          b.param(b.rng.randn(10) * 0.01)],
                 alpha=1.0, beta=1.0, transA=0, transB=1)
        b.output(y)
        return b.g, (batch, 4, 16, 16)
    raise ValueError(name)


def collect_scales(graph, quantable_cls, states_mod):
    """{variable_name: scale_list} for every calibrated ROOT config, split
    into per-tensor activations and per-channel weights."""
    act, wt = {}, {}
    for op in graph.operations.values():
        if not isinstance(op, quantable_cls):
            continue
        pairs = list(zip(op.inputs, op.config.input_quantization_config)) + \
            list(zip(op.outputs, op.config.output_quantization_config))
        for var, cfg in pairs:
            root = cfg.dominated_by if hasattr(cfg, 'dominated_by') else cfg
            if root is not cfg:
                continue                      # only roots own scales
            state = cfg.state
            name = state.name if hasattr(state, 'name') else str(state)
            if name not in ('ACTIVATED', 'BAKED', 'PASSIVE', 'PASSIVE_BAKED'):
                continue
            try:
                scale = np.asarray(cfg.scale, np.float64).reshape(-1)
            except Exception:
                continue
            if getattr(var, 'is_parameter', False):
                if name in ('ACTIVATED', 'BAKED'):   # weights (not bias)
                    # key by OWNING OP, not variable name: the
                    # reference's fuse_bn REPLACES weight vars with
                    # '<op>_weight' (IR/morph.py:591) while ours folds
                    # in place — op names survive fusion on both sides
                    wt[f'{op.name}:w'] = scale.tolist()
            else:
                act[var.name] = scale.tolist()
    return act, wt


def _apply_pass_setting(setting, passes, steps):
    """Turn on the same training/transform pass in either framework's
    setting object (the two expose identical field names by design)."""
    if passes == 'equalization':
        setting.equalization = True
        setting.equalization_setting.iterations = 10
        setting.equalization_setting.value_threshold = 0.5
        setting.equalization_setting.opt_level = 1
    elif passes == 'lsq':
        setting.lsq_optimization = True
        setting.lsq_optimization_setting.steps = steps
        setting.lsq_optimization_setting.lr = 1e-5
        setting.lsq_optimization_setting.collecting_device = 'cpu'
    elif passes == 'bias':
        setting.bias_correct = True
        setting.bias_correct_setting.steps = min(steps, 16)
        setting.bias_correct_setting.block_size = 1
        setting.bias_correct_setting.collecting_device = 'cpu'
    elif passes != 'none':
        raise ValueError(passes)


def collect_params(graph, kinds=('Conv', 'Gemm', 'ConvTranspose')):
    """{param_name: flat value} for weights AND biases of compute ops —
    the tensors equalization rescales and bias correction adjusts."""
    out = {}
    for op in graph.operations.values():
        if getattr(op, 'type', None) not in kinds:
            continue
        for idx, var in enumerate(list(op.inputs)[1:], start=1):
            if getattr(var, 'is_parameter', False) and \
                    var.value is not None:
                v = var.value
                v = v.numpy() if hasattr(v, 'numpy') else np.asarray(v)
                # op-name keys survive the reference's var-renaming fuse
                out[f'{op.name}:{idx}'] = \
                    np.asarray(v, np.float64).reshape(-1)
    return out


def _act_var_names(graph):
    """Non-parameter intermediate variable names (for per-op SNR)."""
    names = []
    for var in graph.variables.values():
        if getattr(var, 'is_parameter', False):
            continue
        if var.name in {v.name for v in graph.inputs.values()}:
            continue
        names.append(var.name)
    return names


def run_ppq_tpu_torch(onnx_path, model_name, batch, loader, observer,
                      passes='none', steps=60, qdq_path=None, per_op=False):
    from ppq_tpu_torch import TargetPlatform, TorchExecutor, quantize_graph
    from ppq_tpu_torch.api.setting import QuantizationSettingFactory
    from ppq_tpu_torch.frontends.onnx.exporter import OnnxExporter
    from ppq_tpu_torch.ir import QuantableOperation

    graph, shape = build_model(model_name, batch)
    # export the FP32 graph — the common input both frameworks quantize
    OnnxExporter().export(onnx_path, graph.copy(copy_value=True))

    fp_ex = TorchExecutor(graph.copy(copy_value=True), device='cpu')
    fp_out = np.concatenate([np.asarray(fp_ex.forward(x)[0])
                             for x in loader])

    setting = QuantizationSettingFactory.default_setting()
    setting.calibration.calib_algorithm = observer
    setting.quantize_activation_setting.calib_algorithm = observer
    _apply_pass_setting(setting, passes, steps)
    quantize_graph(graph, loader, calib_steps=len(loader),
                   platform=TargetPlatform.TPU_INT8, setting=setting,
                   verbose=False, device='cpu')
    ex = TorchExecutor(graph, device='cpu')
    q_out = np.concatenate([np.asarray(ex.forward(x)[0]) for x in loader])
    act, wt = collect_scales(graph, QuantableOperation, None)
    res = {'fp_out': fp_out, 'q_out': q_out, 'act': act, 'wt': wt,
           'params': collect_params(graph)}
    if per_op:
        names = _act_var_names(graph)
        vals = ex.forward(loader[0], output_names=names)
        res['per_op'] = {n: np.asarray(v) for n, v in zip(names, vals)}
    if qdq_path is not None:
        # QDQ artifact of the QUANTIZED graph — the exporter-loop leg
        # feeds this back through the REFERENCE's parser + executor
        from ppq_tpu_torch.frontends.onnxruntime import ONNXRuntimeExporter
        ONNXRuntimeExporter().export(qdq_path, graph.copy(copy_value=True))
    return res


def run_reference(onnx_path, batch, loader, observer,
                  passes='none', steps=60, per_op=False):
    from ppq_tpu_torch.interop import install_onnx_shim
    install_onnx_shim()
    ref_root = os.environ['PPQ_REFERENCE_ROOT']
    sys.path.insert(0, ref_root)
    import torch
    from ppq import QuantizationSettingFactory, TargetPlatform
    from ppq.api import quantize_onnx_model
    from ppq.executor import TorchExecutor
    from ppq.IR import QuantableOperation

    t_loader = [torch.from_numpy(x) for x in loader]
    setting = QuantizationSettingFactory.pplcuda_setting()
    setting.quantize_activation_setting.calib_algorithm = observer
    setting.quantize_parameter_setting.calib_algorithm = 'minmax'
    _apply_pass_setting(setting, passes, steps)
    graph = quantize_onnx_model(
        onnx_import_file=onnx_path, calib_dataloader=t_loader,
        calib_steps=len(t_loader), input_shape=list(loader[0].shape),
        platform=TargetPlatform.PPL_CUDA_INT8, setting=setting,
        device='cpu', verbose=0)
    executor = TorchExecutor(graph, device='cpu')
    with torch.no_grad():
        q_out = np.concatenate(
            [executor.forward(torch.from_numpy(x))[0].numpy()
             for x in loader])
    act, wt = collect_scales(graph, QuantableOperation, None)
    res = {'q_out': q_out, 'act': act, 'wt': wt,
           'params': collect_params(graph)}
    if per_op:
        names = _act_var_names(graph)
        with torch.no_grad():
            vals = executor.forward(torch.from_numpy(loader[0]),
                                    output_names=names)
        res['per_op'] = {n: v.numpy() for n, v in zip(names, vals)}
    return res


def run_reference_on_qdq(qdq_path, loader):
    """The exporter-loop leg: the REFERENCE parses OUR exported QDQ onnx
    and executes it as a plain fp32 graph (QuantizeLinear /
    DequantizeLinear are ordinary ops in its dispatch table) — proving
    the exported ARTIFACT, not just the in-memory graph, carries the
    quantized semantics (reference guarantee:
    tests/test_onnxruntime.py)."""
    from ppq_tpu_torch.interop import install_onnx_shim
    install_onnx_shim()
    ref_root = os.environ['PPQ_REFERENCE_ROOT']
    if ref_root not in sys.path:
        sys.path.insert(0, ref_root)
    import torch
    from ppq.api import load_onnx_graph, register_operation_handler
    from ppq.core import TargetPlatform
    from ppq.executor import TorchExecutor

    # the reference never executes QDQ itself (onnxruntime did) — supply
    # the two textbook ONNX kernels through ITS OWN extension API
    # (ppq/api/interface.py:register_operation_handler); parsing and
    # execution remain entirely the reference's.
    def _qlinear(op, values, ctx=None, **kwargs):
        x, scale = values[0].float(), values[1].float()
        zp = values[2] if len(values) > 2 else \
            torch.zeros_like(values[1], dtype=torch.int8)
        axis = op.attributes.get('axis', 1)
        if scale.numel() > 1:
            shape = [1] * x.dim()
            shape[axis] = -1
            scale = scale.reshape(shape)
            zpb = zp.float().reshape(shape)
        else:
            zpb = zp.float()
        qmin, qmax = (0, 255) if zp.dtype == torch.uint8 else (-128, 127)
        q = torch.round(x / scale) + zpb
        return torch.clamp(q, qmin, qmax).to(zp.dtype)

    def _dqlinear(op, values, ctx=None, **kwargs):
        x, scale = values[0].float(), values[1].float()
        zp = values[2].float() if len(values) > 2 else \
            torch.zeros_like(values[1]).float()
        axis = op.attributes.get('axis', 1)
        if scale.numel() > 1:
            shape = [1] * x.dim()
            shape[axis] = -1
            scale = scale.reshape(shape)
            zp = zp.reshape(shape)
        return (x - zp) * scale

    for t, h in (('QuantizeLinear', _qlinear),
                 ('DequantizeLinear', _dqlinear)):
        for plat in (TargetPlatform.FP32, TargetPlatform.UNSPECIFIED):
            try:
                register_operation_handler(h, t, plat)
            except Exception:
                pass
    graph = load_onnx_graph(qdq_path)
    executor = TorchExecutor(graph, device='cpu')
    with torch.no_grad():
        out = np.concatenate(
            [executor.forward(torch.from_numpy(x))[0].numpy()
             for x in loader])
    return out


def _compare_scales(a: dict, b: dict):
    common = sorted(set(a) & set(b))
    rel = []
    for k in common:
        va, vb = np.asarray(a[k]), np.asarray(b[k])
        if va.shape != vb.shape:
            continue
        rel.append(float(np.max(np.abs(va - vb) / (np.abs(vb) + 1e-12))))
    return {
        'n_ours': len(a), 'n_ref': len(b), 'n_matched': len(common),
        'max_rel_diff': max(rel) if rel else None,
        'mean_rel_diff': float(np.mean(rel)) if rel else None,
    }


def _snr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sum((a - b) ** 2) / (np.sum(b ** 2) + 1e-12))


def _compare_root_multiset(a: dict, b: dict):
    """Alignment-master choices move a group's shared scale to a
    different VARIABLE, so per-name comparison overstates divergence
    (one r4 resblock site read 46% apart although both values were
    legitimate group maxima). The SORTED MULTISET of root scale values is
    master-choice-invariant: same estimators on same data must produce
    the same set of group scales."""
    common = sorted(set(a) & set(b))   # same granularity on both sides
    va = np.sort(np.concatenate([np.asarray(a[k], np.float64).reshape(-1)
                                 for k in common])) if common \
        else np.array([])
    vb = np.sort(np.concatenate([np.asarray(b[k], np.float64).reshape(-1)
                                 for k in common])) if common \
        else np.array([])
    if len(va) != len(vb) or len(va) == 0:
        return {'n_ours': len(va), 'n_ref': len(vb), 'max_rel_diff': None}
    rel = np.abs(va - vb) / (np.abs(vb) + 1e-12)
    return {'n_ours': len(va), 'n_ref': len(vb),
            'max_rel_diff': float(np.max(rel)),
            'mean_rel_diff': float(np.mean(rel))}


def _compare_params(a: dict, b: dict):
    """Post-pass parameter agreement (equalization-rescaled weights,
    corrected biases)."""
    common = sorted(set(a) & set(b))
    per = {}
    for k in common:
        va, vb = a[k], b[k]
        if va.shape != vb.shape:
            continue
        denom = np.max(np.abs(vb)) + 1e-12
        per[k] = float(np.max(np.abs(va - vb)) / denom)
    return {'n_matched': len(per),
            'max_rel_diff': max(per.values()) if per else None,
            'mean_rel_diff': float(np.mean(list(per.values())))
            if per else None,
            'worst': sorted(per, key=per.get)[-3:] if per else []}


def _compare_per_op(a: dict, b: dict):
    common = sorted(set(a) & set(b))
    snrs = {}
    for k in common:
        if a[k].shape != b[k].shape:
            continue
        snrs[k] = _snr(a[k], b[k])
    if not snrs:
        return {'n_matched': 0}
    worst = sorted(snrs, key=snrs.get)[-5:]
    return {'n_matched': len(snrs),
            'max_snr': max(snrs.values()),
            'mean_snr': float(np.mean(list(snrs.values()))),
            'worst_ops': {k: snrs[k] for k in worst}}


def _ensure_python_protobuf():
    """The reference's old-gen ppl_caffe_pb2.py only loads under the pure-
    python protobuf implementation, and the env var must be set before
    google.protobuf first loads — which `import ppq_tpu_torch` already did when
    we got here (package __init__ runs before this module). Re-exec with
    the env set when needed."""
    from google.protobuf.internal import api_implementation
    if api_implementation.Type() != 'python':
        env = dict(os.environ,
                   PROTOCOL_BUFFERS_PYTHON_IMPLEMENTATION='python')
        os.execve(sys.executable,
                  [sys.executable, '-m',
                   'ppq_tpu_torch.interop.reference_parity']
                  + sys.argv[1:], env)


def main():
    _ensure_python_protobuf()
    ap = argparse.ArgumentParser()
    ap.add_argument('out_json')
    ap.add_argument('--model', default='convnet')
    ap.add_argument('--observer', default='minmax')
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--steps', type=int, default=8)
    ap.add_argument('--passes', default='none',
                    choices=['none', 'equalization', 'lsq', 'bias'])
    ap.add_argument('--train-steps', type=int, default=200)
    ap.add_argument('--qdq-loop', action='store_true')
    ap.add_argument('--per-op', action='store_true')
    args = ap.parse_args()

    rng = np.random.RandomState(7)
    shape = {'convnet': (args.batch, 3, 16, 16),
             'resblock': (args.batch, 4, 16, 16),
             'resnet18': (args.batch, 3, 224, 224)}[args.model]
    loader = [rng.randn(*shape).astype(np.float32)
              for _ in range(args.steps)]

    tmp = tempfile.gettempdir()
    onnx_path = os.path.join(tmp, f'parity_{args.model}.onnx')
    qdq_path = os.path.join(
        tmp, f'parity_{args.model}_qdq.onnx') if args.qdq_loop else None
    ours = run_ppq_tpu_torch(onnx_path, args.model, args.batch, loader,
                       args.observer, passes=args.passes,
                       steps=args.train_steps, qdq_path=qdq_path,
                       per_op=args.per_op)
    ref = run_reference(onnx_path, args.batch, loader, args.observer,
                        passes=args.passes, steps=args.train_steps,
                        per_op=args.per_op)

    result = {
        'model': args.model, 'observer': args.observer,
        'passes': args.passes,
        'activation_scales': _compare_scales(ours['act'], ref['act']),
        'activation_root_multiset': _compare_root_multiset(ours['act'],
                                                           ref['act']),
        'weight_scales': _compare_scales(ours['wt'], ref['wt']),
        'params': _compare_params(ours['params'], ref['params']),
        # SNR of the two frameworks' INT8-simulated outputs against each
        # other, and each against fp32 (the Δ both must agree on)
        'sim_cross_snr': _snr(ours['q_out'], ref['q_out']),
        'ours_vs_fp32_snr': _snr(ours['q_out'], ours['fp_out']),
        'ref_vs_fp32_snr': _snr(ref['q_out'], ours['fp_out']),
    }
    if args.per_op:
        result['per_op'] = _compare_per_op(ours['per_op'], ref['per_op'])
    if args.qdq_loop:
        # reference executes OUR exported QDQ artifact as a plain graph
        qdq_out = run_reference_on_qdq(qdq_path, loader)
        result['qdq_artifact_snr'] = _snr(qdq_out, ours['q_out'])
    with open(args.out_json, 'w') as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == '__main__':
    main()
