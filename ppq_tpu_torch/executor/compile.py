"""Whole-graph execution of a (quantized) BaseGraph, captured as CUDA graphs.

Counterpart of ppq_tpu/executor/compile.py, where the whole graph (ops,
fake-quant sites, dequant epilogues, calibration statistics) is traced once
into one jitted XLA program instead of one Python dispatch per op. The port's
counterpart of `jax.jit` is a CUDA graph: the same walk over the ops
(`CompiledGraph._trace`) runs once uncaptured, then once more inside
`torch.cuda.graph`, and every later call with inputs of the same shapes
copies them into the capture's static buffers and replays it: one graph
launch for the whole forward. On the CPU the same walk runs uncaptured.

Three modes:
  * inference:   build_forward() / make_runner(chain)  -> outputs
  * calibration: build_calibration_forward(spec)       -> (outputs, stats)
                 (the functional observer transform: min/max, quantiles,
                 abs-max and histograms computed on the device in the walk)
  * training:    build_trainable_forward()             -> outputs that
                 carry the autograd graph back to params and qparams (the
                 fake-quant sites are the autograd Functions of
                 quantization/qfunction.py). It runs uncaptured: a caller
                 captures a whole step (forward, loss, backward, optimizer)
                 instead (quantization/optim/training.py `_CapturedStep`).

What a capture freezes. A CUDA graph replays the kernels with the arguments
they had at capture: a host number passed to a kernel (the histogram's scale,
a quant grid's offsets checked on the host) is a constant of the graph, and
so is the address of every device tensor read, among them the scales and
offsets that `device_qparams` keeps per root TQC. A capture holds those
pairs, so that a TQC dropping its own (a new scale, offset, state or
dominator) frees nothing the graph reads. A runner therefore closes over its
qparams, as the JAX package's runner closes over them as trace constants:
after `write_back_qparams` or a calibration, build a new one.
Nothing in the walk may synchronise with the host; shape-chain (SOI) ops are
evaluated in numpy on host values at trace time (`_soi_eval`), and one that
meets a tensor on the card raises instead of reading it back.

`LAUNCHES` (kernels/loader.py) counts a kernel where its wrapper launches
it: at the uncaptured walk and at the capture, not at a replay. Each capture
records the launches it holds (`launches_per_replay`).

precision:
  'highest' float32 convolutions and products, TF32 off (the eager
            executor's fidelity);
  'int'     integer-exact simulation: quantized Conv / Gemm contract their
            centered integer codes, stored as float32, with float32
            accumulation, and the scales are applied to the output axis
            (`_int_exact_forward`). Every partial sum is an integer, exact in
            float32 below 2^24 whatever the order of summation, and TF32
            holds the codes (|code| <= 256) exactly; ops whose worst case
            exceeds 2^24 are recorded in `int_accum_risk` (rejected under
            `int_accum_guard`). The JAX package stores the codes in bf16 and
            asks XLA for an f32 result; PyTorch's bf16 convolution returns
            bf16, which would round the sums, so the port keeps float32.
            cuDNN takes the algorithm of these contractions from its
            heuristics whatever `cudnn.benchmark` says
            (`_integer_contraction`): a timed choice may take a Winograd or
            FFT algorithm, whose transforms round integer sums;
  'default' float32 storage, TF32 convolutions and products (the card's
            default-precision math; the TPU's is bf16 passes);
  'bf16'    every float tensor stored in bf16, TF32 products; quantization
            arithmetic in float32.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import (OBSERVER_KL_HIST_BINS, QuantizationStates,
                    TargetPlatform, TensorQuantizationConfig)
from ..ir import BaseGraph, Operation, QuantableOperation
# the quantization package first: it imports the kernels in the order
# their modules need
from ..quantization.observers import quantile_rows_tensor
from ..quantization.qfunction import (device_qparams,
                                      dynamic_linear_fake_quant,
                                      filled_scalar, floating_fake_quant,
                                      linear_fake_quant,
                                      linear_quant_codes,
                                      linear_recover_codes, ppq_fake_quant)
from ..kernels.histogram import histogram
from ..kernels.loader import LAUNCHES, graph_capture
from .base import resolve_forward
from .ops.default import ExecContext, _host, simulation_precision

# op types whose outputs depend on input *data* in shape-affecting ways: a
# captured graph has static shapes
UNCOMPILABLE_TYPES = {'NonZero', 'NonMaxSuppression'}

# op types eligible for the integer-exact lowering (precision 'int'): the
# quantized contraction runs over centered integer codes with a float32
# accumulator, the scales factored out. Exact whenever partial sums stay
# below 2^24 (guaranteed when reduction_len * |codes_x|max * |codes_w|max
# <= 2^24, which `int_accum_risk` records where it does not hold).
INT_EXACT_TYPES = {'Conv', 'ConvTranspose', 'Gemm', 'MatMul',
                   'PPQBiasFusedMatMul'}

# ops the int-exact mode propagates CODES through without dequantizing:
# order-preserving (f(c*s) == f(c)*s for s > 0) or pure layout
INT_CODED_PASSTHRU = {'Relu', 'MaxPool', 'GlobalMaxPool', 'Flatten',
                      'Reshape', 'Transpose', 'Identity', 'Squeeze',
                      'Unsqueeze'}

# ops the int-exact mode computes ON code sums (shared input grids).
# Informational inventory only, as in the JAX package: _int_forward's
# branches own the eligibility checks; keep the two in sync.
INT_CODED_LINEAR = {'Add', 'Sum', 'Concat', 'GlobalAveragePool',
                    'AveragePool', 'ReduceMean'}


class _Coded:
    """Integer-exact intermediate: centered integer codes (float32) and the
    grid they live on: value == codes * scale. `scale` is a float32 tensor
    on the codes' device; `uid` the root TQC's uid (equal uid: same grid);
    lo / hi bound the centered codes."""
    __slots__ = ('codes', 'scale', 'axis', 'uid', 'lo', 'hi')

    def __init__(self, codes, scale, axis, uid, lo, hi):
        self.codes, self.scale, self.axis = codes, scale, axis
        self.uid, self.lo, self.hi = uid, lo, hi

    def decode(self):
        c = self.codes.to(torch.float32)
        if self.axis is not None:
            shape = [1] * c.ndim
            shape[self.axis] = -1
            return c * self.scale.reshape(shape)
        return c * self.scale.reshape(())


def _decode(v):
    """Materialize the float value of a (possibly coded) intermediate."""
    return v.decode() if isinstance(v, _Coded) else v


# ---------------------------------------------------------------------------
# Host (numpy) evaluation of SOI-region ops at trace time: shape chains stay
# concrete so that their consumers (Reshape, Slice, Resize) see static
# shapes, the trace-time realization of the scheduler's SOI split.
def _soi_eval(op, vals):
    t = op.type
    attrs = op.attributes
    # Shape/Size read only static metadata: valid on any tensor
    if t == 'Shape':
        start = int(attrs.get('start', 0))
        end = attrs.get('end')
        return np.asarray(list(vals[0].shape)[start: None if end is None
                                              else int(end)], np.int64)
    if t == 'Size':
        return np.asarray(int(np.prod(vals[0].shape)), np.int64)
    a = [_host(op, v) for v in vals]
    if t == 'Gather':
        return np.take(a[0], a[1].astype(np.int64),
                       axis=int(attrs.get('axis', 0)))
    if t == 'GatherElements':
        return np.take_along_axis(a[0], a[1].astype(np.int64),
                                  axis=int(attrs.get('axis', 0)))
    if t == 'Unsqueeze':
        axes = (a[1].reshape(-1).tolist() if len(a) > 1
                else list(attrs.get('axes', [0])))
        out = a[0]
        for ax in sorted(int(x) for x in axes):
            out = np.expand_dims(out, ax)
        return out
    if t == 'Squeeze':
        axes = (a[1].reshape(-1).tolist() if len(a) > 1
                else attrs.get('axes'))
        return (np.squeeze(a[0]) if axes is None
                else np.squeeze(a[0], axis=tuple(int(x) for x in axes)))
    if t == 'Concat':
        xs = [x for x in a if x.size > 0] or a
        return np.concatenate([np.atleast_1d(x) for x in xs],
                              axis=int(attrs.get('axis', 0)))
    if t == 'Slice':
        starts = a[1].reshape(-1).astype(np.int64)
        ends = a[2].reshape(-1).astype(np.int64)
        axes = (a[3].reshape(-1).astype(np.int64) if len(a) > 3
                else np.arange(len(starts)))
        steps = (a[4].reshape(-1).astype(np.int64) if len(a) > 4
                 else np.ones(len(starts), np.int64))
        sl = [slice(None)] * a[0].ndim
        for s, e, ax, st in zip(starts, ends, axes, steps):
            sl[int(ax)] = slice(int(s), int(e), int(st))
        return a[0][tuple(sl)]
    if t == 'Cast':
        from ..core import DataType
        return a[0].astype(DataType(int(attrs['to'])).numpy_dtype)
    if t in ('Add', 'Sub', 'Mul', 'Div', 'Mod'):
        fn = {'Add': np.add, 'Sub': np.subtract, 'Mul': np.multiply,
              'Div': lambda x, y: (x // y if np.issubdtype(x.dtype, np.integer)
                                   else x / y),
              'Mod': np.mod}[t]
        return fn(a[0], a[1])
    if t in ('ReduceProd', 'ReduceSum', 'ReduceMax', 'ReduceMin'):
        fn = {'ReduceProd': np.prod, 'ReduceSum': np.sum,
              'ReduceMax': np.max, 'ReduceMin': np.min}[t]
        axes = attrs.get('axes')
        axes = tuple(int(x) for x in axes) if axes is not None else None
        return fn(a[0], axis=axes,
                  keepdims=bool(attrs.get('keepdims', 1)))
    if t == 'ConstantOfShape':
        value = np.asarray(attrs.get('value', np.zeros(1, np.float32)))
        return np.full([int(v) for v in a[0].reshape(-1)],
                       value.reshape(-1)[0], dtype=value.dtype)
    if t == 'Range':
        return np.arange(a[0].reshape(-1)[0], a[1].reshape(-1)[0],
                         a[2].reshape(-1)[0])
    if t == 'Where':
        return np.where(a[0], a[1], a[2])
    if t == 'Reshape':
        shape = [int(v) for v in a[1].reshape(-1)]
        if not int(attrs.get('allowzero', 0)):
            shape = [a[0].shape[i] if v == 0 else v
                     for i, v in enumerate(shape)]
        return a[0].reshape(shape)
    if t == 'Transpose':
        return np.transpose(a[0], attrs.get('perm'))
    if t == 'Expand':
        return np.broadcast_to(a[0], [int(v) for v in a[1].reshape(-1)])
    if t == 'Identity':
        return a[0]
    if t == 'Equal':
        return np.equal(a[0], a[1])
    raise NotImplementedError(
        f'SOI op {op.type} ({op.name}) has no host (numpy) evaluation: '
        f'add it to _soi_eval or dispatch it off the compiled region.')


def compilable(graph: BaseGraph) -> Tuple[bool, List[str]]:
    bad = [op.name for op in graph.operations.values()
           if op.type in UNCOMPILABLE_TYPES]
    return (len(bad) == 0), bad


def _cfg_key(cfg: TensorQuantizationConfig) -> str:
    return f'tqc{hash(cfg.dominated_by)}'


def _is_trainable_cfg(cfg: TensorQuantizationConfig) -> bool:
    root = cfg.dominated_by
    return root.state in {QuantizationStates.ACTIVATED,
                          QuantizationStates.PASSIVE} and root.has_scale


@contextlib.contextmanager
def _integer_contraction():
    """The flags of a contraction over integer codes, restored on exit: TF32
    allowed (it holds the codes exactly), and `cudnn.benchmark` off, so that
    cuDNN takes its algorithm from its heuristics (implicit GEMM for
    ResNet-18's convolutions on the H100) and not from timing, which may
    pick a Winograd or FFT algorithm whose transforms round integer sums."""
    cudnn = torch.backends.cudnn
    benchmark = cudnn.benchmark
    cudnn.benchmark = False
    try:
        with simulation_precision('default'):
            yield
    finally:
        cudnn.benchmark = benchmark


def _mean_of_codes(op, codes: torch.Tensor) -> torch.Tensor:
    """GlobalAveragePool / ReduceMean / AveragePool over integer codes as
    the sum (exact) divided by the count, an IEEE quotient on every device
    (a reduction's mean may multiply by the count's reciprocal instead)."""
    if op.type == 'GlobalAveragePool':
        dims = tuple(range(2, codes.ndim))
        keep = True
    elif op.type == 'ReduceMean':
        axes = op.attributes.get('axes')
        dims = (tuple(int(a) % codes.ndim for a in axes) if axes is not None
                else tuple(range(codes.ndim)))
        keep = bool(op.attributes.get('keepdims', 1))
    else:
        return None
    count = int(np.prod([codes.shape[d] for d in dims]))
    return torch.sum(codes, dim=dims, keepdim=keep) / filled_scalar(
        count, codes.device)


class _Capture:
    """One walk captured into a CUDA graph for fixed input shapes.

    `body(inputs)` runs once uncaptured on a side stream (it loads and
    builds the kernels, builds cuDNN's plans and uploads the qparams, none
    of which a capture may do), then inside `torch.cuda.graph`. A call
    copies the inputs into the static buffers and replays the graph; the
    outputs are the capture's static tensors, which the next replay
    overwrites. `held()` returns, after the capture, the device tensors made
    before it that the graph reads and that nothing else may keep alive (the
    roots' `device_qparams`): the capture holds them."""

    def __init__(self, body: Callable, inputs: Dict[str, torch.Tensor],
                 held: Callable[[], list]):
        device = next(iter(inputs.values())).device
        self.static_in = {k: v.detach().clone().contiguous()
                          for k, v in inputs.items()}
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body(self.static_in)
        torch.cuda.current_stream(device).wait_stream(side)
        before = dict(LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with graph_capture(self.graph):
            self.static_out = body(self.static_in)
        self.held = held()
        self.launches = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES
                         if LAUNCHES[k] != before.get(k, 0)}

    def __call__(self, inputs: Dict[str, torch.Tensor]):
        for k, v in inputs.items():
            self.static_in[k].copy_(v)
        self.graph.replay()
        return self.static_out


class CompiledGraph:
    """Compile a BaseGraph (or a contiguous op span of it) into captured
    forward functions on `device` (the card unless the caller names
    another)."""

    def __init__(self, graph: BaseGraph,
                 output_names: Optional[List[str]] = None,
                 op_span: Optional[Sequence[Operation]] = None,
                 input_names: Optional[List[str]] = None,
                 precision: str = 'highest',
                 int_accum_guard: bool = False,
                 device=None):
        from .executor import resolve_device
        if precision not in ('highest', 'int', 'default', 'bf16'):
            raise ValueError(f'unknown precision {precision!r}')
        self.precision = precision
        self.device = resolve_device(device)
        span = list(op_span) if op_span is not None else None
        bad = [op.name for op in (span or graph.operations.values())
               if op.type in UNCOMPILABLE_TYPES]
        if bad:
            raise ValueError(
                f'Graph contains data-dependent ops that cannot be captured '
                f'with static shapes: {bad}. Use the eager TorchExecutor.')
        self.graph = graph
        self._order = span if span is not None else graph.topological_sort()
        self._ctx = ExecContext(graph, self._order, self.device)
        if span is not None:
            produced = {v.name for op in span for v in op.outputs}
            if input_names is None:
                input_names = sorted({
                    v.name for op in span for v in op.inputs
                    if not v.is_parameter and v.name not in produced})
            if output_names is None:
                output_names = sorted(
                    {v.name for op in span for v in op.outputs
                     if v.name in graph.outputs or any(
                         d not in span for d in v.dest_ops)})
            self._param_scope = {v.name for op in span for v in op.inputs
                                 if v.is_parameter}
        else:
            input_names = list(input_names or graph.inputs.keys())
            output_names = list(output_names or graph.outputs.keys())
            self._param_scope = None
        self.output_names = list(output_names)
        self._input_names = list(input_names)
        # ops lowered through the integer-exact path (filled at trace time)
        self.int_lowered: List[str] = []
        # ops that propagate / compute on integer codes without dequantizing
        self.int_coded: List[str] = []
        # lowered ops whose WORST-CASE partial sum exceeds 2^24
        self.int_accum_risk: List[str] = []
        self._int_accum_guard = bool(int_accum_guard)
        # weight parameters pre-lowered to integer codes by init_params
        self._precoded: Dict[str, dict] = {}
        # called with (op, codes_x, codes_w, integer sums) by every lowered
        # contraction of an uncaptured walk, where set (an exactness check
        # can hold the sums against an integer reference)
        self.int_probe: Optional[Callable] = None
        if precision == 'int':
            self._build_precoded()

    # ------------------------------------------------------------ pytrees
    def init_params(self) -> Dict[str, torch.Tensor]:
        """Float parameters on the device, as the walk reads them (weights
        stay arguments of the walk, not constants of the graph's code)."""
        from ..ir import soi_input_indices
        # params at SOI input slots (Reshape shapes, ...) stay host values
        soi_vars = set()
        for op in self._order:
            for idx in soi_input_indices(op):
                if idx < len(op.inputs):
                    soi_vars.add(op.inputs[idx].name)
        out = {}
        for name, var in self.graph.variables.items():
            if self._param_scope is not None and name not in self._param_scope:
                continue
            if name in soi_vars:
                continue
            if var.is_parameter and var.has_value:
                val = np.asarray(var.value)
                if np.issubdtype(val.dtype, np.floating):
                    if name in self._precoded:
                        out[name] = self._precode_weight(name, val)
                        continue
                    t = torch.as_tensor(np.asarray(val, np.float32),
                                        device=self.device)
                    out[name] = (t.to(torch.bfloat16)
                                 if self.precision == 'bf16' else t)
        return out

    def init_qparams(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """One {scale, offset} per *root* active TQC (slaves resolve to their
        dominator)."""
        out = {}
        for op in self._order:
            if not isinstance(op, QuantableOperation):
                continue
            for cfg in op.config:
                root = cfg.dominated_by
                if not _is_trainable_cfg(root):
                    continue
                key = _cfg_key(root)
                if key not in out:
                    out[key] = {
                        'scale': torch.as_tensor(
                            np.asarray(root.scale, np.float32),
                            device=self.device),
                        'offset': torch.as_tensor(
                            np.asarray(root.offset, np.float32),
                            device=self.device),
                    }
        return out

    def write_back_qparams(self, qparams: Dict[str, Dict[str, torch.Tensor]]):
        """Push scales / offsets back onto the IR's TQCs. A runner built
        before keeps the values it was captured with (its captures hold the
        device scales they read): build a new one."""
        seen = {}
        for op in self._order:
            if not isinstance(op, QuantableOperation):
                continue
            for cfg in op.config:
                root = cfg.dominated_by
                key = _cfg_key(root)
                if key in qparams and key not in seen:
                    root.scale = qparams[key]['scale'].detach().cpu().numpy()
                    root.offset = qparams[key]['offset'].detach().cpu().numpy()
                    seen[key] = True

    # ------------------------------------------------------------- tracing
    def _apply_quant(self, value, cfg: TensorQuantizationConfig,
                     qparams: Optional[dict]):
        if cfg is None:
            return value
        if not isinstance(value, torch.Tensor) or \
                not value.is_floating_point():
            return value
        if not cfg.is_active:
            return value
        # quantization arithmetic runs in float32 (bf16 storage included)
        value = value.to(torch.float32).contiguous()
        if cfg.policy.dynamic:
            return dynamic_linear_fake_quant(
                value, cfg.quant_min, cfg.quant_max,
                symmetric=cfg.policy.symmetric, rounding=cfg.rounding,
                channel_axis=cfg.channel_axis)
        if qparams is not None:
            key = _cfg_key(cfg)
            if key in qparams:
                scale = qparams[key]['scale']
                offset = qparams[key]['offset']
                if cfg.policy.floating:
                    return floating_fake_quant(
                        value, scale, cfg.exponent_bits,
                        cfg.num_of_bits - 1 - cfg.exponent_bits,
                        cfg.quant_min, cfg.quant_max)
                return linear_fake_quant(
                    value, scale, offset, cfg.quant_min, cfg.quant_max,
                    cfg.rounding, cfg.channel_axis)
        return ppq_fake_quant(value, cfg)

    # ------------------------------------------- integer-exact simulation
    @staticmethod
    def _weight_axes(op, w_ndim: int):
        """(expected weight scale axis | None, output channel axis | None
        meaning 'last axis of y') for an INT_EXACT_TYPES op."""
        t = op.type
        if t == 'Conv':
            return 0, 1                  # OIHW weights -> NCHW outputs
        if t == 'ConvTranspose':
            return 1, 1                  # IOHW weights
        if t == 'Gemm':
            return (0 if int(op.attributes.get('transB', 0)) else 1), 1
        # MatMul / PPQBiasFusedMatMul: a 1-D rhs has only the contraction
        # axis, so a per-channel scale there cannot factor out
        return ((w_ndim - 1) if w_ndim >= 2 else None), None

    def _int_site(self, cfg: TensorQuantizationConfig,
                  expected_axis: Optional[int],
                  ndim: Optional[int] = None) -> Optional[dict]:
        """Resolve `cfg` to a usable integer grid for the int-exact mode, or
        None where the site is ineligible: {site, already, scale, offset
        (host arrays), scale_t, offset_t (the same on the device), axis, uid,
        lo, hi, bound}. `already`: the value arriving here is already
        fake-quantized (OVERLAPPED under an active dominator, or BAKED).
        lo / hi bound the centered codes; any <= 8-bit scheme qualifies.
        expected_axis None requires a per-tensor scale (the activation
        side); an int allows per-tensor or per-channel on exactly that axis
        (the weight side)."""
        if cfg is None:
            return None
        root = cfg.dominated_by
        if cfg.is_active:
            site, already = cfg, False
        elif (cfg.state == QuantizationStates.OVERLAPPED and
              QuantizationStates.is_activated(root.state)):
            site, already = root, True
        elif cfg.state in (QuantizationStates.BAKED,
                           QuantizationStates.PASSIVE_BAKED):
            site, already = cfg, True
        else:
            return None
        pol = site.policy
        if not pol.linear or pol.dynamic or pol.floating or \
                not site.has_scale:
            return None
        scale = np.asarray(site.scale, np.float32)
        offset = (np.asarray(site.offset, np.float32)
                  if pol.asymmetric else np.zeros_like(scale))
        axis = site.channel_axis if pol.per_channel else None
        if axis is not None:
            if ndim is not None:
                axis = axis % ndim
            if expected_axis is None or axis != expected_axis:
                return None
        elif scale.size != 1:
            return None
        o_r = np.round(offset)
        lo = float(np.min(site.quant_min - o_r))
        hi = float(np.max(site.quant_max - o_r))
        bound = max(abs(lo), abs(hi))
        if bound > 256:
            return None
        scale_t, offset_t = device_qparams(site, self.device)
        return {'site': site, 'already': already, 'scale': scale,
                'offset': offset, 'scale_t': scale_t, 'offset_t': offset_t,
                'axis': axis, 'uid': root._uid, 'lo': lo, 'hi': hi,
                'bound': bound}

    @staticmethod
    def _quant_codes(v, info):
        return linear_quant_codes(
            v.to(torch.float32).contiguous(), info['scale_t'],
            info['offset_t'], info['site'].quant_min, info['site'].quant_max,
            info['site'].rounding, info['axis'])

    @staticmethod
    def _recover_codes(v, info):
        return linear_recover_codes(
            v.to(torch.float32), info['scale_t'], info['offset_t'],
            info['site'].quant_min, info['site'].quant_max, info['axis'])

    def _codes_for_site(self, v, cfg: TensorQuantizationConfig,
                        expected_axis: Optional[int]):
        """Lower input `v` (raw value, fake-quantized value, or _Coded) to
        centered integer codes at `cfg`'s site: (codes, info), or None when
        ineligible."""
        if not isinstance(v, (torch.Tensor, _Coded)) or \
                (isinstance(v, torch.Tensor) and not v.is_floating_point()):
            return None
        if isinstance(v, _Coded):
            info = self._int_site(cfg, expected_axis, ndim=v.codes.ndim)
            if info is None:
                return None
            if v.axis is None and info['axis'] is None and \
                    info['uid'] == v.uid:
                codes = v.codes
                # the consumer's range may be narrower than the producer's
                if info['lo'] > v.lo or info['hi'] < v.hi:
                    codes = torch.clamp(codes, info['lo'], info['hi'])
                info = dict(info, lo=max(info['lo'], v.lo),
                            hi=min(info['hi'], v.hi))
                info['bound'] = max(abs(info['lo']), abs(info['hi']))
                return codes, info
            # a different grid: requantize through the decoded value
            return self._quant_codes(v.decode(), info), info
        info = self._int_site(cfg, expected_axis, ndim=v.ndim)
        if info is None:
            return None
        if info['already']:
            # fake-quantized upstream: divide the grid back out
            return self._recover_codes(v, info), info
        return self._quant_codes(v, info), info

    def _build_precoded(self):
        """Register the weights of int-lowerable ops for pre-coding:
        init_params ships them as integer codes, so no forward re-derives
        them."""
        for op in self._order:
            if not isinstance(op, QuantableOperation):
                continue
            if op.type not in INT_EXACT_TYPES or len(op.inputs) < 2:
                continue
            wvar = op.inputs[1]
            if not wvar.is_parameter or not wvar.has_value:
                continue
            if len(wvar.dest_ops) != 1 or wvar.name in self._precoded:
                continue
            w_val = np.asarray(wvar.value)
            if not np.issubdtype(w_val.dtype, np.floating):
                continue
            cfgs = op.config.input_quantization_config
            if len(cfgs) < 2:
                continue
            w_axis, _ = self._weight_axes(op, w_val.ndim)
            info = self._int_site(cfgs[1], expected_axis=w_axis,
                                  ndim=w_val.ndim)
            if info is None:
                continue
            if op.type == 'ConvTranspose' and \
                    int(op.attributes.get('group', 1)) != 1 and \
                    info['scale'].size != 1:
                continue   # per-channel axis 1 covers only C_out/group rows
            self._precoded[wvar.name] = info

    def _precode_weight(self, name: str, value: np.ndarray) -> torch.Tensor:
        """The float32 integer codes of a registered weight, on the device
        (the channelwise fake-quant kernel's codes where the weight is not
        baked yet)."""
        info = self._precoded[name]
        w = torch.as_tensor(np.asarray(value, np.float32), device=self.device)
        if info['already']:
            return self._recover_codes(w, info)
        return self._quant_codes(w, info)

    @staticmethod
    def _reduction_len(op, w_shape, group: int) -> int:
        t = op.type
        if t == 'Conv':
            return int(np.prod(w_shape[1:]))
        if t == 'ConvTranspose':
            return (w_shape[0] // group) * int(np.prod(w_shape[2:]))
        if t == 'Gemm':
            return w_shape[1 if int(op.attributes.get('transB', 0)) else 0]
        return w_shape[-2] if len(w_shape) >= 2 else w_shape[0]

    def _int_exact_forward(self, op, in_vals):
        """Integer-exact lowering of a quantized Conv / Gemm / MatMul: the
        contraction over float32 integer codes with a float32 accumulator
        (TF32 allowed: it holds the codes exactly), then s_x * s_w on the
        output axis and the fake-quantized bias. Returns [y] or None to take
        the generic path."""
        t = op.type
        if t not in INT_EXACT_TYPES or len(in_vals) < 2:
            return None
        cfgs = op.config.input_quantization_config
        if len(cfgs) < 2:
            return None
        x, w = in_vals[0], in_vals[1]
        if isinstance(w, _Coded):
            w_shape = tuple(w.codes.shape)
        elif isinstance(w, torch.Tensor):
            w_shape = tuple(w.shape)
        else:
            return None
        group = int(op.attributes.get('group', 1))
        w_axis, out_axis = self._weight_axes(op, len(w_shape))
        rx = self._codes_for_site(x, cfgs[0], expected_axis=None)
        if rx is None:
            return None
        if isinstance(w, _Coded):
            # pre-coded parameter (built against this op's own cfg)
            qw, sw, bw = w.codes, w.scale, max(abs(w.lo), abs(w.hi))
        else:
            rw = self._codes_for_site(w, cfgs[1], expected_axis=w_axis)
            if rw is None:
                return None
            qw, sw, bw = rw[0], rw[1]['scale_t'], rw[1]['bound']
        qx, xinfo = rx
        sx, bx = xinfo['scale_t'], xinfo['bound']
        if t == 'ConvTranspose' and group != 1 and sw.numel() != 1:
            return None   # per-channel axis 1 covers only C_out/group rows
        # float32 partial sums are exact integers only below 2^24
        if self._reduction_len(op, w_shape, group) * bx * bw > 2.0 ** 24:
            if op.name not in self.int_accum_risk:
                self.int_accum_risk.append(op.name)
            if self._int_accum_guard:
                return None
        fn = resolve_forward(op.platform, op.type)
        with _integer_contraction():
            y = fn(op, [qx, qw], self._ctx)
        if isinstance(y, (tuple, list)):
            y = y[0]
        if self.int_probe is not None and not (
                y.is_cuda and torch.cuda.is_current_stream_capturing()):
            self.int_probe(op, qx, qw, y)
        sxs = sx.reshape(())
        if sw.numel() == 1:
            y = y * (sxs * sw.reshape(()))
        else:
            shape = [1] * y.ndim
            shape[out_axis if out_axis is not None else y.ndim - 1] = -1
            y = y * (sxs * sw.reshape(shape))
        if len(in_vals) > 2 and in_vals[2] is not None and \
                _decode(in_vals[2]).numel() > 0:
            b = self._apply_quant(_decode(in_vals[2]),
                                  cfgs[2] if len(cfgs) > 2 else None, None)
            b = b.to(torch.float32)
            if t in ('Conv', 'ConvTranspose'):
                y = y + b.reshape((1, -1) + (1,) * (y.ndim - 2))
            elif t == 'Gemm':
                y = y + b * float(op.attributes.get('beta', 1.0))
            else:
                y = y + b
        if op.name not in self.int_lowered:
            self.int_lowered.append(op.name)
        return [y]

    def _int_forward(self, op, in_vals):
        """Integer-exact handling of one quantable op: output values (plain
        tensors or _Coded) with output-site quantization applied, or None to
        take the generic float path."""
        t = op.type
        if t in INT_EXACT_TYPES:
            outs = self._int_exact_forward(op, in_vals)
            if outs is None:
                return None
            return self._quant_outputs_int(op, outs)
        cfgs = op.config.input_quantization_config
        if t in INT_CODED_PASSTHRU and len(op.outputs) == 1 and \
                isinstance(in_vals[0], _Coded):
            v = in_vals[0]
            if v.axis is not None:
                return None
            cfg0 = cfgs[0] if cfgs else None
            if cfg0 is not None and cfg0.is_active:
                r = self._codes_for_site(v, cfg0, expected_axis=None)
                if r is None:
                    return None
                codes, info = r
                scale, uid = info['scale_t'], info['uid']
                lo, hi = info['lo'], info['hi']
            else:
                codes, scale, uid, lo, hi = v.codes, v.scale, v.uid, v.lo, v.hi
            fn = resolve_forward(op.platform, op.type)
            y = fn(op, [codes] + [_decode(x) for x in in_vals[1:]], self._ctx)
            if isinstance(y, (tuple, list)):
                y = y[0]
            if t == 'Relu':
                lo = max(lo, 0.0)
            out = _Coded(y, scale, None, uid, lo, hi)
            if op.name not in self.int_coded:
                self.int_coded.append(op.name)
            return self._quant_outputs_int(op, [out])
        if t in ('Add', 'Sum') and len(in_vals) == 2 and \
                len(op.outputs) == 1 and \
                all(isinstance(v, _Coded) for v in in_vals):
            # residual adds: QuantAlignment puts the inputs on one grid, and
            # the sum of codes is exact (|sum| <= 512)
            rs = [self._codes_for_site(v, c, None)
                  for v, c in zip(in_vals, cfgs)]
            if any(r is None for r in rs):
                return None
            s0 = float(rs[0][1]['scale'].reshape(()))
            if float(rs[1][1]['scale'].reshape(())) != s0:
                return None
            y = (rs[0][0] + rs[1][0]) * rs[0][1]['scale_t'].reshape(())
            if op.name not in self.int_coded:
                self.int_coded.append(op.name)
            return self._quant_outputs_int(op, [y])
        if t == 'Concat' and len(op.outputs) == 1 and \
                all(isinstance(v, _Coded) for v in in_vals):
            rs = [self._codes_for_site(v, c, None)
                  for v, c in zip(in_vals, cfgs)]
            if any(r is None for r in rs):
                return None
            s0 = float(rs[0][1]['scale'].reshape(()))
            if any(float(r[1]['scale'].reshape(())) != s0 for r in rs[1:]):
                return None
            if any(r[1]['uid'] != rs[0][1]['uid'] for r in rs[1:]):
                return None
            codes = torch.cat([r[0] for r in rs],
                              dim=int(op.attributes.get('axis', 0)))
            out = _Coded(codes, rs[0][1]['scale_t'], None, rs[0][1]['uid'],
                         min(r[1]['lo'] for r in rs),
                         max(r[1]['hi'] for r in rs))
            if op.name not in self.int_coded:
                self.int_coded.append(op.name)
            return self._quant_outputs_int(op, [out])
        if t in ('GlobalAveragePool', 'AveragePool', 'ReduceMean') and \
                len(op.outputs) == 1 and isinstance(in_vals[0], _Coded):
            # linear in the input: mean(codes) * s, the code sum exact
            r = self._codes_for_site(in_vals[0], cfgs[0], None)
            if r is None:
                return None
            codes, info = r
            y = _mean_of_codes(op, codes)
            if y is None:
                fn = resolve_forward(op.platform, op.type)
                y = fn(op, [codes] + [_decode(x) for x in in_vals[1:]],
                       self._ctx)
                if isinstance(y, (tuple, list)):
                    y = y[0]
            y = y * info['scale_t'].reshape(())
            if op.name not in self.int_coded:
                self.int_coded.append(op.name)
            return self._quant_outputs_int(op, [y])
        return None

    def _quant_outputs_int(self, op, outs):
        cfgs = op.config.output_quantization_config
        return [self._quant_one_output_int(v, c)
                for v, c in zip(outs, list(cfgs) + [None] * len(outs))]

    def _quant_one_output_int(self, v, cfg: TensorQuantizationConfig):
        """Output-site quantization in the integer-exact mode: a _Coded
        (the float dequant never materializes unless a consumer that is not
        code-aware decodes) or a plain tensor."""
        if isinstance(v, _Coded):
            if cfg is None or not cfg.is_active:
                return v                      # quantized elsewhere
            info = self._int_site(cfg, expected_axis=None, ndim=v.codes.ndim)
            if info is None:
                return self._apply_quant(v.decode(), cfg, None)
            if v.axis is None and info['axis'] is None and \
                    info['uid'] == v.uid:
                if info['lo'] <= v.lo and info['hi'] >= v.hi:
                    return v                  # already on this grid
                return _Coded(torch.clamp(v.codes, info['lo'], info['hi']),
                              v.scale, None, v.uid,
                              max(info['lo'], v.lo), min(info['hi'], v.hi))
            codes = self._quant_codes(v.decode(), info)
            return _Coded(codes, info['scale_t'], None, info['uid'],
                          info['lo'], info['hi'])
        if cfg is None or not cfg.is_active:
            return self._apply_quant(v, cfg, None)
        if not isinstance(v, torch.Tensor) or not v.is_floating_point():
            return v
        info = self._int_site(cfg, expected_axis=None, ndim=v.ndim)
        if info is None:
            # per-channel / non-linear / > 8-bit output: plain fake-quant
            return self._apply_quant(v, cfg, None)
        codes = self._quant_codes(v, info)
        return _Coded(codes, info['scale_t'], None, info['uid'], info['lo'],
                      info['hi'])

    def _collect_stat(self, stats: dict, var_name: str,
                      cfg: TensorQuantizationConfig, value,
                      stat_spec, hist_scales: Optional[dict],
                      ranges: Optional[dict] = None):
        """One site's calibration statistic, on the device:
          minmax          (min, max) over all axes but the channel axis
          percentile      (lo, hi) quantiles, `quantile_rows_tensor` (top-k)
          quantile_bisect (lo, hi) by 24 bisection steps on the threshold
          absmax          max |x|
          hist            |x| histogram at ranges / hist_scales' scale
          absmax_hist     (max |x|, |x| histogram)
          hist_signed     histogram of (x - lo) at the range's width
        Histograms are row 3's int64 counts (the JAX package's are int32)."""
        if not isinstance(value, torch.Tensor) or \
                not value.is_floating_point():
            return
        spec = stat_spec if isinstance(stat_spec, dict) else None
        if spec is not None:
            entry = spec.get(var_name)
            if entry is None:
                return
            kind = entry['kind'] if isinstance(entry, dict) else entry
        else:
            entry = None      # bare-string spec: branches below fall back
            kind = stat_spec
        v = value.to(torch.float32)
        if cfg.policy.per_channel and cfg.channel_axis is not None:
            axes = tuple(i for i in range(v.ndim)
                         if i != cfg.channel_axis % v.ndim)
        else:
            axes = tuple(range(v.ndim))

        def bins_of(entry):
            return (entry.get('bins', OBSERVER_KL_HIST_BINS)
                    if isinstance(entry, dict) else OBSERVER_KL_HIST_BINS)

        if kind == 'minmax':
            if axes:
                stats[var_name] = (torch.amin(v, dim=axes),
                                   torch.amax(v, dim=axes))
            else:
                stats[var_name] = (v.clone(), v.clone())
        elif kind == 'percentile':
            pct = entry.get('percentile', 0.9999) if isinstance(entry, dict) \
                else 0.9999
            if cfg.policy.per_channel and cfg.channel_axis is not None:
                ax = cfg.channel_axis % v.ndim
                rows = torch.movedim(v, ax, 0).reshape(v.shape[ax], -1)
                hi = quantile_rows_tensor(rows, pct)
                lo = quantile_rows_tensor(rows, 1.0 - pct)
            else:
                rows = v.reshape(1, -1)
                hi = quantile_rows_tensor(rows, pct)[0]
                lo = quantile_rows_tensor(rows, 1.0 - pct)[0]
            stats[var_name] = (lo, hi)
        elif kind == 'quantile_bisect':
            # per-tensor quantile without a sort: 24 bisection steps on the
            # threshold, compare and count; the smallest data-bracketing
            # threshold at (range / 2^24) resolution
            pct = entry.get('percentile', 0.9999) if isinstance(entry, dict) \
                else 0.9999
            flat = v.reshape(-1)
            qs = np.asarray([1.0 - pct, pct], np.float32) * flat.numel()
            qs = torch.stack([filled_scalar(q, v.device) for q in qs])
            lo0 = torch.amin(flat)
            hi0 = torch.amax(flat)
            span = torch.clamp(hi0 - lo0, min=1e-30)
            lo = (lo0 - 1e-3 * span).expand(2).clone()
            hi = hi0.expand(2).clone()
            for _ in range(24):
                mid = 0.5 * (lo + hi)
                cnt = torch.sum(flat[None, :] <= mid[:, None],
                                dim=1).to(torch.float32)
                ok = cnt >= qs
                lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
            stats[var_name] = (hi[0], hi[1])
        elif kind == 'absmax':
            stats[var_name] = torch.amax(torch.abs(v))
        elif kind in ('hist', 'absmax_hist'):
            # the scale is a kernel argument: a host number, frozen into a
            # captured graph (the calibration pass captures sweep 2 anew)
            if ranges is not None and var_name in ranges:
                scale = ranges[var_name]
            elif kind == 'hist':
                scale = hist_scales[var_name]
            else:
                scale = (hist_scales or {}).get(var_name, 1.0)
            counts = histogram(v.contiguous(), float(scale), bins_of(entry),
                               absolute=True)
            stats[var_name] = (counts if kind == 'hist'
                               else (torch.amax(torch.abs(v)), counts))
        elif kind == 'hist_signed':
            if ranges is not None and var_name in ranges:
                lo, width = ranges[var_name]
            else:
                lo, width = entry['lo'], entry['width']
            shifted = (v - filled_scalar(lo, v.device)).reshape(-1) \
                .contiguous()
            stats[var_name] = histogram(shifted, float(width),
                                        bins_of(entry), absolute=False)

    def _trace(self, params: dict, qparams: Optional[dict], inputs: dict,
               stat_kind=None, hist_scales: Optional[dict] = None,
               ranges: Optional[dict] = None):
        values: Dict[str, Any] = {}
        stats: Dict[str, Any] = {}
        # integer-exact mode engages only for plain inference (calibration
        # needs live float values)
        is_int = (self.precision == 'int' and qparams is None
                  and stat_kind is None)

        def cast(v):
            # bf16 deploy storage: every float tensor between ops in bf16
            if self.precision == 'bf16' and isinstance(v, torch.Tensor) and \
                    v.is_floating_point():
                return v.to(torch.bfloat16)
            return v

        for name in self._input_names:
            values[name] = cast(inputs[name])

        def fetch(var):
            if var.name in values:
                return values[var.name]
            if var.is_parameter:
                if var.name in params:
                    if var.name in self._precoded:
                        # the leaf holds codes (init_params): wrap, so that
                        # paths that are not int decode the fq value
                        m = self._precoded[var.name]
                        return _Coded(params[var.name], m['scale_t'],
                                      m['axis'], m['uid'], m['lo'], m['hi'])
                    return params[var.name]
                return var.value          # SOI operands stay host values
            raise RuntimeError(f'compile: no value for {var.name}')

        for op in self._order:
            in_vals = [fetch(v) for v in op.inputs]
            int_outs = None
            if isinstance(op, QuantableOperation):
                cfgs = op.config.input_quantization_config
                if stat_kind is not None:
                    for var, cfg, v in zip(op.inputs, cfgs, in_vals):
                        if (not var.is_parameter and cfg.is_root and
                                cfg.state == QuantizationStates.INITIAL):
                            self._collect_stat(stats, var.name, cfg,
                                               _decode(v), stat_kind,
                                               hist_scales, ranges)
                if is_int:
                    # the lowering consumes raw / coded values and quantizes
                    # on codes itself; it returns output-quantized values
                    int_outs = self._int_forward(op, in_vals)
                if int_outs is None:
                    in_vals = [cast(self._apply_quant(_decode(v), c,
                                                      qparams))
                               for v, c in zip(in_vals, cfgs)]
            else:
                in_vals = [_decode(v) for v in in_vals]
            if int_outs is not None:
                outs = int_outs
            elif op.platform == TargetPlatform.SOI or \
                    op.type in ('Shape', 'Size'):
                outs = _soi_eval(op, in_vals)
            else:
                fn = resolve_forward(op.platform, op.type)
                outs = fn(op, in_vals, self._ctx)
            if not isinstance(outs, (tuple, list)):
                outs = [outs]
            if isinstance(op, QuantableOperation) and int_outs is None:
                cfgs = op.config.output_quantization_config
                if stat_kind is not None:
                    for var, cfg, v in zip(op.outputs, cfgs, outs):
                        if cfg.is_root and \
                                cfg.state == QuantizationStates.INITIAL:
                            self._collect_stat(stats, var.name, cfg, v,
                                               stat_kind, hist_scales,
                                               ranges)
                if is_int:
                    outs = self._quant_outputs_int(op, outs)
                else:
                    outs = [cast(self._apply_quant(v, c, qparams))
                            for v, c in zip(outs, cfgs)]
            for var, v in zip(op.outputs, outs):
                values[var.name] = v

        out_vals = []
        for name in self.output_names:
            if name in values:
                out_vals.append(_decode(values[name]))
            else:
                out_vals.append(self.graph.variables[name].value)
        return out_vals, stats

    # ------------------------------------------------------ forward functions
    def _feed(self, inputs) -> Dict[str, torch.Tensor]:
        """inputs (one array, a sequence or a dict) as float32 tensors on
        the device."""
        if not isinstance(inputs, dict):
            if isinstance(inputs, (list, tuple)):
                inputs = dict(zip(self._input_names, inputs))
            else:
                inputs = {self._input_names[0]: inputs}
        out = {}
        for k, v in inputs.items():
            t = v if isinstance(v, torch.Tensor) else \
                torch.as_tensor(np.asarray(v))
            if t.is_floating_point():
                t = t.to(torch.float32)
            out[k] = t.to(self.device).contiguous()
        return out

    def _walk(self, params, inputs) -> List[torch.Tensor]:
        """The inference walk: outputs in float32 whatever the storage."""
        with torch.no_grad(), simulation_precision(self.precision):
            outs, _ = self._trace(params, None, inputs)
        return [o.to(torch.float32)
                if isinstance(o, torch.Tensor) and o.is_floating_point()
                else o for o in outs]

    def _captured(self, cache: dict, key, body, inputs):
        """The capture for `key`, made on first use (CPU: None)."""
        if self.device.type != 'cuda':
            return None
        call = cache.get(key)
        if call is None:
            call = cache[key] = _Capture(body, inputs, self._device_qparams)
        return call

    def _device_qparams(self) -> list:
        """The (scale, offset) pairs that the roots of this graph's TQCs keep
        on the device now (`device_qparams`)."""
        roots = {}
        for op in self._order:
            if isinstance(op, QuantableOperation):
                for cfg in op.config:
                    roots[id(cfg.dominated_by)] = cfg.dominated_by
        return [pair for root in roots.values()
                for pair in root._device_qparams.values()]

    @staticmethod
    def _shape_key(inputs: Dict[str, torch.Tensor]):
        return tuple((k, tuple(v.shape), v.dtype)
                     for k, v in sorted(inputs.items()))

    def build_forward(self) -> Callable:
        """fn(params, inputs) -> [outputs]. On the card one capture per
        input shape (and parameter set); a call replays it. On the CPU the
        walk runs as it is."""
        cache: dict = {}

        def fn(params, inputs):
            inputs = self._feed(inputs)
            key = (self._shape_key(inputs),
                   tuple(p.data_ptr() for p in params.values()))
            call = self._captured(cache, key,
                                  lambda x: self._walk(params, x), inputs)
            if call is None:
                return self._walk(params, inputs)
            return [o.clone() for o in call(inputs)]
        return fn

    def build_trainable_forward(self) -> Callable:
        """fn(params, qparams, inputs) -> [outputs], differentiable in
        params and qparams (the LSQ scale and offset gradients of the
        fake-quant sites' backward kernels). The walk runs as it is, with
        autograd on; the outputs keep the storage dtype of the precision."""
        def fn(params, qparams, inputs):
            inputs = self._feed(inputs)
            with torch.enable_grad(), simulation_precision(self.precision):
                outs, _ = self._trace(params, qparams, inputs)
            return outs
        return fn

    def build_calibration_forward(self, stat_kind='minmax',
                                  hist_scales: Optional[Dict[str, float]] = None
                                  ) -> Callable:
        """fn(params, inputs, ranges=None) -> ([outputs], stats): the
        functional observer transform. On the card one capture per input
        shape and set of `ranges` (histogram scales and ranges are kernel
        arguments, constants of a capture); the returned tensors are the
        capture's own and the next call overwrites them, so a caller folds
        them before calling again."""
        hs = None
        if hist_scales is not None:
            hs = {k: float(v) for k, v in hist_scales.items()}
        cache: dict = {}

        def body(params, inputs, ranges):
            with torch.no_grad(), simulation_precision('highest'):
                return self._trace(params, None, inputs, stat_kind=stat_kind,
                                   hist_scales=hs, ranges=ranges)

        def fn(params, inputs, ranges=None):
            inputs = self._feed(inputs)
            key = (self._shape_key(inputs),
                   tuple(p.data_ptr() for p in params.values()),
                   None if ranges is None else tuple(
                       (k, tuple(np.asarray(v, np.float64).reshape(-1)))
                       for k, v in sorted(ranges.items())))
            call = self._captured(cache, key,
                                  lambda x: body(params, x, ranges), inputs)
            if call is None:
                return body(params, inputs, ranges)
            return call(inputs)
        fn.captures = cache
        return fn

    # ---------------------------------------------------------- conveniences
    def make_runner(self, chain: int = 1) -> '_Runner':
        """Self-contained inference callable: closes over device-resident
        params (and over the qparams as they are now); accepts one array, a
        sequence or a dict of inputs.

        chain > 1 builds the bulk runner: inputs carry a leading chain axis
        (chain, batch, ...) and the whole chain is ONE capture (the walk
        `chain` times back to back, outputs stacked): one graph launch a
        chain. Every forward of the chain runs the same kernels on its own
        slice, so the stacked outputs equal `chain` calls of the chain-1
        runner bit for bit."""
        return _Runner(self, self.init_params(), int(chain))


class _Runner:
    """make_runner's callable. `launches_per_replay`: the kernel launches
    the latest capture holds, by kernel; `walk(inputs)`: the same work
    uncaptured."""

    def __init__(self, cg: CompiledGraph, params: dict, chain: int):
        self.cg, self.params, self.chain = cg, params, chain
        self.captures: dict = {}
        self.launches_per_replay: Dict[str, int] = {}

    def walk(self, inputs):
        return self._walk_raw(self.cg._feed(inputs))

    def __call__(self, inputs):
        inputs = self.cg._feed(inputs)
        if self.chain > 1 and any(v.shape[0] != self.chain
                                  for v in inputs.values()):
            raise ValueError(f'a chain-{self.chain} runner takes inputs with '
                             f'a leading axis of {self.chain}')
        call = self.cg._captured(self.captures,
                                 CompiledGraph._shape_key(inputs),
                                 self._walk_raw, inputs)
        if call is None:
            return self.walk(inputs)
        self.launches_per_replay = call.launches
        return [o.clone() for o in call(inputs)]

    def _walk_raw(self, inputs):
        if self.chain == 1:
            return self.cg._walk(self.params, inputs)
        steps = [self.cg._walk(self.params, {k: v[i] for k, v in
                                             inputs.items()})
                 for i in range(self.chain)]
        return [torch.stack([s[j] for s in steps])
                for j in range(len(steps[0]))]


def compile_graph(graph: BaseGraph,
                  output_names: Optional[List[str]] = None,
                  precision: str = 'highest',
                  int_accum_guard: bool = False,
                  device=None) -> CompiledGraph:
    return CompiledGraph(graph, output_names, precision=precision,
                         int_accum_guard=int_accum_guard, device=device)
