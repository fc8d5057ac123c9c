"""The op library's cases: every op type of the port's DEFAULT_BACKEND_TABLE
(and the NXP Resize) at small seeded shapes, with the attributes of
tests/test_op_parity_torch.py and tests/test_op_edge_cases.py and the edge
cases of each op. One module feeds three checks:

  * tests/test_torch_ops*.py: each case through the JAX package's op and
    the port's on the CPU, within `jax` (0: equal);
  * tests/test_torch_cuda.py and chip_smoke.py (`--ops`): each case through
    the port's op on the card and on the CPU, within `card` (0: equal).

It imports nothing of JAX. A tolerance is (rtol, atol) for
numpy.testing.assert_allclose, or 0 for equality (NaN equal to NaN).
Integer outputs are compared as values: the port's are int64 where the JAX
package's (x64 off) are int32 (ROADMAP.md queue 3, item 35).

An input is handed to the port as a tensor (on the device under test) when
it is a float array, and as a host numpy array otherwise or where the case
lists it in `host`: shape and index operands, as the executors hand them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

EXACT = 0
# elementwise transcendental functions: the libraries' implementations
# round differently by a few units in the last place
ULP = (2e-6, 1e-6)
# sums in another order (reductions, norms, softmax, pooling windows)
SUM = (1e-5, 1e-6)
# products and convolutions in float32, TF32 off: the libraries block the
# sums in other orders
MATMUL = (1e-4, 1e-5)
# recurrent and attention ops: products inside a loop
LOOP = (1e-4, 1e-5)


class Case:
    """One call of one op: `inputs` (numpy), `attrs`, `n_out` outputs. `jax`
    and `card` are the tolerances of the two checks; `platform` names a
    TargetPlatform whose table the op is resolved in (the NXP Resize)."""

    def __init__(self, op_type: str, inputs: Sequence, attrs=None,
                 n_out: int = 1, host: Sequence[int] = (), jax=EXACT,
                 card=None, platform: Optional[str] = None,
                 name: str = ''):
        self.op_type = op_type
        self.inputs = list(inputs)
        self.attrs = dict(attrs or {})
        self.n_out = n_out
        self.host = set(host)
        self.jax = jax
        self.card = jax if card is None else card
        self.platform = platform
        self.id = f'{op_type}-{name}' if name else op_type


def _r(seed):
    return np.random.RandomState(seed)


def _f(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _i(values):
    return np.asarray(values, np.int64)


CASES: List[Case] = []


def _add(*args, **kw):
    CASES.append(Case(*args, **kw))


# ------------------------------------------------------------ conv family
for n, (stride, pad, dil, group) in enumerate(
        [(1, 1, 1, 1), (2, 0, 1, 1), (1, 2, 2, 1), (1, 1, 1, 4)]):
    rng = _r(100 + n)
    _add('Conv', [_f(rng, 2, 8, 13, 11), _f(rng, 12, 8 // group, 3, 3),
                  _f(rng, 12)],
         dict(kernel_shape=[3, 3], strides=[stride, stride], pads=[pad] * 4,
              dilations=[dil, dil], group=group), jax=MATMUL,
         name=f's{stride}p{pad}d{dil}g{group}')
rng = _r(104)
_add('Conv', [_f(rng, 2, 4, 9, 9), _f(rng, 6, 4, 3, 3)],
     dict(kernel_shape=[3, 3], pads=[0, 1, 2, 1], strides=[2, 1]),
     jax=MATMUL, name='asymmetric-pads')
_add('Conv', [_f(rng, 2, 4, 9, 8), _f(rng, 6, 4, 3, 3)],
     dict(kernel_shape=[3, 3], auto_pad='SAME_UPPER', strides=[2, 2]),
     jax=MATMUL, name='same-upper')
_add('Conv', [_f(rng, 2, 4, 17), _f(rng, 6, 4, 3), _f(rng, 6)],
     dict(kernel_shape=[3], pads=[1, 1], strides=[2]), jax=MATMUL,
     name='1d')
for n, (stride, pad, outpad) in enumerate([(2, 0, 0), (2, 1, 1), (3, 1, 0)]):
    rng = _r(110 + n)
    _add('ConvTranspose', [_f(rng, 1, 6, 7, 9), _f(rng, 6, 4, 3, 3)],
         dict(kernel_shape=[3, 3], strides=[stride, stride], pads=[pad] * 4,
              output_padding=[outpad, outpad], dilations=[1, 1], group=1),
         jax=MATMUL, name=f's{stride}p{pad}o{outpad}')
rng = _r(113)
_add('ConvTranspose', [_f(rng, 1, 8, 6, 6), _f(rng, 8, 2, 2, 2),
                       _f(rng, 4)],
     dict(kernel_shape=[2, 2], strides=[2, 2], pads=[0] * 4,
          dilations=[1, 1], group=2), jax=MATMUL, name='grouped-bias')
_add('ConvTranspose', [_f(rng, 2, 3, 5, 4), _f(rng, 3, 5, 3, 3)],
     dict(kernel_shape=[3, 3], strides=[2, 2], pads=[0, 1, 1, 0],
          output_padding=[1, 0], dilations=[2, 1]), jax=MATMUL,
     name='asymmetric-dilated')
_add('ConvTranspose', [_f(rng, 2, 3, 7), _f(rng, 3, 4, 4)],
     dict(kernel_shape=[4], strides=[2], pads=[1, 2]), jax=MATMUL,
     name='1d')

# ------------------------------------------------------------ pool family
for ceil in (0, 1):
    rng = _r(120 + ceil)
    _add('MaxPool', [_f(rng, 2, 4, 11, 13)],
         dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1],
              ceil_mode=ceil), name=f'ceil{ceil}')
    for include in (0, 1):
        _add('AveragePool', [_f(rng, 2, 4, 10, 11)],
             dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1],
                  count_include_pad=include, ceil_mode=ceil), jax=SUM,
             name=f'include{include}-ceil{ceil}')
rng = _r(122)
_add('AveragePool', [_f(rng, 2, 3, 9, 9)],
     dict(kernel_shape=[2, 2], strides=[2, 2], ceil_mode=1), jax=SUM,
     name='ceil-no-pads')
_add('AveragePool', [_f(rng, 2, 3, 12)],
     dict(kernel_shape=[3], strides=[2], pads=[1, 0]), jax=SUM, name='1d')
_add('GlobalAveragePool', [_f(rng, 2, 5, 6, 7)], jax=SUM)
_add('GlobalMaxPool', [_f(rng, 2, 5, 6, 7)])
_add('AdaptiveAvgPool2d', [_f(rng, 2, 3, 8, 8)], dict(output_size=[2, 4]),
     jax=SUM, name='divides')
_add('AdaptiveAvgPool2d', [_f(rng, 2, 3, 7, 9)], dict(output_size=[3, 4]),
     jax=SUM, name='bins')

# ---------------------------------------------------------- linear algebra
rng = _r(130)
_add('Gemm', [_f(rng, 5, 7), _f(rng, 3, 7), _f(rng, 3)],
     dict(transB=1, alpha=0.5, beta=2.0), jax=MATMUL, name='transB')
_add('Gemm', [_f(rng, 7, 5), _f(rng, 7, 3), _f(rng, 5, 3)],
     dict(transA=1), jax=MATMUL, name='transA')
_add('MatMul', [_f(rng, 2, 4, 16, 8), _f(rng, 2, 4, 8, 16)], jax=MATMUL,
     name='heads')
_add('MatMul', [_f(rng, 3, 16, 32), _f(rng, 32, 24)], jax=MATMUL,
     name='dense')
_add('MatMul', [_f(rng, 3, 8), _f(rng, 8)], jax=MATMUL, name='vector')
_add('PPQBiasFusedMatMul', [_f(rng, 3, 16, 32), _f(rng, 32, 24),
                            _f(rng, 24)], jax=MATMUL)
_add('Einsum', [_f(rng, 2, 5, 7), _f(rng, 2, 7, 3)],
     dict(equation='bij,bjk->bik'), jax=MATMUL, name='batched')
_add('Einsum', [_f(rng, 4, 6)], dict(equation='ij->ji'), name='transpose')

# ------------------------------------------------------------- elementwise
rng = _r(140)
A, B = _f(rng, 3, 4, 5, scale=3), _f(rng, 4, 5, scale=3)
B[B == 0] = 1.0
for t in ('Add', 'Sub', 'Mul', 'Div'):
    _add(t, [A, B], name='broadcast')
_add('Add', [_i([[1, 2], [3, 4]]), _i([10, 20])], name='host-ints')
_add('Pow', [np.abs(A) + 0.1, _f(rng, 1, 5)], jax=ULP)
_add('Mod', [A, B], name='float')
_add('Mod', [_i([7, -7, 7, -7, 0]), _i([3, 3, -3, -3, 5])], name='int')
for t in ('Max', 'Min', 'Sum'):
    _add(t, [A, B, _f(rng, 1, 5)], name='three')
X = _f(rng, 3, 17, scale=3)
for t in ('Relu', 'Abs', 'Neg', 'Floor', 'Ceil', 'Sign', 'Identity',
          'HardSwish'):
    _add(t, [X])
_add('Round', [np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, 0.49, 3.7, -2.2],
                          np.float32)], name='ties-to-even')
_add('Reciprocal', [B])
for t in ('Sigmoid', 'Tanh', 'Exp', 'Erf', 'Sin', 'Cos', 'Tan', 'Softplus',
          'Mish', 'Swish', 'SiLU', 'Gelu'):
    _add(t, [X], jax=ULP)
_add('Gelu', [X], dict(approximate='tanh'), jax=ULP, name='tanh-attribute')
_add('Softplus', [X * 20], jax=ULP, name='wide')
for t in ('Log', 'Sqrt'):
    _add(t, [np.abs(X) + 0.01], jax=ULP if t == 'Log' else EXACT)
_add('HardSigmoid', [X], dict(alpha=1 / 6, beta=0.5))
_add('HardSigmoid', [X], name='defaults')
_add('LeakyRelu', [X], dict(alpha=0.1))
_add('PRelu', [_f(rng, 2, 6, 5, 5), (rng.rand(6) * 0.5).astype(np.float32)],
     name='channel-slope')
_add('PRelu', [_f(rng, 2, 6, 5, 5),
               (rng.rand(1, 6, 1, 1) * 0.5).astype(np.float32)],
     name='4d-slope')
_add('Clip', [X, np.asarray(-1.0, np.float32), np.asarray(2.0, np.float32)],
     name='both')
_add('Clip', [X, np.asarray(0.0, np.float32)], name='low')
_add('Clip', [X], name='none')
_add('Elu', [X], dict(alpha=0.7), jax=ULP)
_add('Selu', [X], jax=ULP)
T = np.asarray([[0.0, 1.0, 2.0], [2.0, 1.0, 0.0]], np.float32)
U = np.asarray([1.0, 1.0, 1.0], np.float32)
for t in ('Equal', 'Greater', 'GreaterOrEqual', 'Less', 'LessOrEqual'):
    _add(t, [T, U])
P = np.asarray([[True, False], [True, True]])
Q = np.asarray([False, True])
for t in ('And', 'Or', 'Xor'):
    _add(t, [P, Q])
_add('Not', [P])
_add('Where', [T > U, T, _f(rng, 2, 3)])
_add('Where', [np.asarray([1.0, 0.0, 2.0], np.float32), U, -U],
     host=(0,), name='float-condition')

# -------------------------------------------------------------- softmax
rng = _r(150)
_add('Softmax', [_f(rng, 2, 3, 8, scale=4)], dict(axis=-1), jax=SUM,
     name='last')
_add('Softmax', [_f(rng, 2, 3, 8, scale=4)], dict(axis=1), jax=SUM,
     name='axis1')
_add('LogSoftmax', [_f(rng, 2, 3, 8, scale=4)], dict(axis=-1), jax=SUM)

# -------------------------------------------------------------- norms
rng = _r(160)
C = 6
_add('BatchNormalization', [_f(rng, 2, C, 4, 4), rng.rand(C).astype(np.float32)
                            + 0.5, _f(rng, C), _f(rng, C),
                            rng.rand(C).astype(np.float32) + 0.5],
     dict(epsilon=1e-5))
G, Bt = rng.rand(16).astype(np.float32) + 0.5, _f(rng, 16)
_add('LayerNormalization', [_f(rng, 2, 5, 16), G, Bt],
     dict(axis=-1, epsilon=1e-5), jax=SUM, name='last')
_add('LayerNormalization', [_f(rng, 2, 4, 4, 4),
                            rng.rand(4, 4, 4).astype(np.float32),
                            _f(rng, 4, 4, 4)], dict(axis=1), jax=SUM,
     name='axis1')
_add('LayerNormalization', [_f(rng, 2, 5, 16), G], jax=SUM, name='no-bias')
_add('LayerNorm', [_f(rng, 2, 5, 16), G, Bt], jax=SUM)
_add('InstanceNormalization', [_f(rng, 2, 4, 9, 7),
                               rng.rand(4).astype(np.float32) + 0.5,
                               _f(rng, 4)], dict(epsilon=1e-5), jax=SUM)
_add('GroupNormalization', [_f(rng, 2, 6, 5, 5), _f(rng, 6), _f(rng, 6)],
     dict(num_groups=3), jax=SUM)
for size in (3, 4):
    _add('LRN', [_f(rng, 2, 7, 4, 4)], dict(size=size, alpha=1e-3, beta=0.75,
                                            bias=2.0), jax=SUM,
         name=f'size{size}')
_add('skipLayerNormPlugin', [_f(rng, 2, 5, 16), _f(rng, 2, 5, 16), G, Bt],
     jax=SUM, name='beta')
_add('skipLayerNormPlugin', [_f(rng, 2, 5, 16), _f(rng, 2, 5, 16), G],
     jax=SUM, name='no-beta')

# ------------------------------------------------------- shape / movement
rng = _r(170)
Y = _f(rng, 2, 3, 4, 5)
_add('Reshape', [Y, _i([0, -1, 5])], name='zero-copies')
_add('Reshape', [Y, _i([2, 0, -1])], dict(allowzero=0), name='zero-middle')
for axis in (0, 1, 2):
    _add('Flatten', [Y], dict(axis=axis), name=f'axis{axis}')
_add('Transpose', [Y], dict(perm=[0, 2, 3, 1]))
_add('Transpose', [Y], name='reverse')
_add('Squeeze', [_f(rng, 1, 3, 1, 2), _i([0, -2])], name='axes')
_add('Squeeze', [_f(rng, 1, 3, 1, 2)], name='all')
_add('Unsqueeze', [_f(rng, 3, 4), _i([0, -1])], name='ends')
_add('Unsqueeze', [_f(rng, 3, 4), _i([1, 3])], name='middle')
_add('Concat', [_f(rng, 2, 3), _f(rng, 2, 1), _f(rng, 2, 4)], dict(axis=1))
_add('Concat', [_f(rng, 2, 3), np.zeros((2, 0), np.float32), _f(rng, 2, 2)],
     dict(axis=1), name='empty')
_add('Concat', [_i([2]), _i([3, 4])], dict(axis=0), name='host-shapes')
_add('Split', [_f(rng, 2, 9), _i([2, 3, 4])], dict(axis=1), n_out=3,
     name='sizes')
_add('Split', [_f(rng, 6, 2)], dict(axis=0, split=[1, -1]), n_out=2,
     name='caffe-tail')
_add('Split', [_f(rng, 2, 9)], dict(axis=1), n_out=3, name='equal')
S = np.arange(60, dtype=np.float32).reshape(3, 4, 5)
for name, args in (
        ('basic', [_i([0, 1]), _i([2, 4]), _i([0, 2])]),
        ('steps', [_i([0, 4]), _i([3, 0]), _i([1, 2]), _i([2, -1])]),
        ('negative-step', [_i([3]), _i([0]), _i([1]), _i([-1])]),
        ('clamped-ends', [_i([-100, 1]), _i([100, 2 ** 31])]),
        ('reverse-to-int-min', [_i([-1]), _i([-2 ** 63]), _i([2]),
                                _i([-1])]),
        ('reverse-all', [_i([4]), _i([-6]), _i([2]), _i([-2])]),
        ('empty', [_i([3]), _i([1]), _i([2])])):
    _add('Slice', [S] + args, name=name)
Z = _f(rng, 2, 3, 4, 5)
_add('Pad', [Z, _i([0, 0, 1, 2, 0, 0, 2, 1]), np.asarray(1.5, np.float32)],
     dict(mode='constant'), host=(2,), name='constant')
_add('Pad', [Z, _i([0, 0, 1, 2, 0, 0, 2, 1])], name='constant-zero')
_add('Pad', [Z, _i([0, 0, 1, 2, 0, 0, 2, 1]), np.asarray(1.5, np.float32)],
     dict(mode='constant'), name='constant-value-tensor')
for mode in ('reflect', 'edge', 'wrap'):
    _add('Pad', [Z, _i([0, 1, 1, 2, 0, 0, 2, 3])], dict(mode=mode),
         name=mode)
_add('Pad', [Z, _i([0, 0, 6, 0, 0, 0, 0, 7])], dict(mode='reflect'),
     name='reflect-wider-than-axis')
_add('Expand', [_f(rng, 3, 1), _i([2, 1, 4])], name='broadcast')
_add('Expand', [_f(rng, 2, 5), _i([1, 1])], name='ones-keep')
_add('Expand', [_f(rng, 2, 1), _i([-1, 3])], name='minus-one')
_add('Tile', [_f(rng, 2, 3), _i([2, 3])], name='full')
_add('Tile', [_f(rng, 2, 3), _i([3])], name='leading')
for mode in ('DCR', 'CRD'):
    _add('DepthToSpace', [_f(rng, 2, 8, 3, 4)], dict(blocksize=2, mode=mode),
         name=mode)
_add('SpaceToDepth', [_f(rng, 2, 4, 6, 6)], dict(blocksize=2))
_add('ChannelShuffle', [_f(rng, 2, 8, 4, 4)], dict(group=4))

# the first file of CPU checks takes the cases above, the second the rest
FIRST_FILE = len(CASES)

# ----------------------------------------------------- indexing and types
rng = _r(180)
D = _f(rng, 5, 4, 3)
_add('Gather', [D, _i([[0, 4], [-1, 2]])], dict(axis=0), name='axis0')
_add('Gather', [D, _i([3, 0, -4])], dict(axis=1), name='axis1-negative')
_add('Gather', [D, _i(2)], dict(axis=-1), name='scalar')
_add('Gather', [_i([2, 3, 8, 8]), _i(0)], dict(axis=0), name='shape-chain')
_add('GatherElements', [D, _i(rng.randint(-3, 3, (5, 4, 2)))],
     dict(axis=2), name='axis2')
_add('GatherElements', [D, _i(rng.randint(0, 5, (2, 4, 3)))],
     dict(axis=0), name='axis0')
_add('GatherND', [D, _i([[0, 1], [4, 3], [2, 0]])], name='b0')
_add('GatherND', [_f(rng, 2, 4, 5), _i([[[1], [3]], [[0], [2]]])],
     dict(batch_dims=1), name='b1')
_add('GatherND', [_f(rng, 2, 3, 4, 6), _i(rng.randint(0, 4, (2, 3, 1)))],
     dict(batch_dims=2), name='b2')
# ScatterND / ScatterElements: unique indices, as ONNX requires for
# reduction 'none' (duplicates are undefined, and on the card the write
# that lands is not fixed)
_add('ScatterND', [D, _i([[4, 1], [0, 3], [2, 2]]), _f(rng, 3, 3)],
     name='rows')
_add('ScatterND', [D, _i([[1], [3]]), _f(rng, 2, 4, 3)], name='slices')
_add('ScatterElements', [_f(rng, 8), _i([6, 1, 3]), _f(rng, 3)],
     dict(axis=0), name='1d')
_add('ScatterElements', [_f(rng, 3, 5), _i([[4, 0], [1, 3], [2, -1]]),
                         _f(rng, 3, 2)], dict(axis=1), name='2d-axis1')
CAST_IN = np.asarray([3e9, -3e9, np.nan, 2.7, -2.7, 300.0, -5.0, 0.0],
                     np.float32)
for to, name in ((6, 'int32'), (3, 'int8'), (2, 'uint8'), (9, 'bool'),
                 (10, 'float16'), (1, 'float32')):
    _add('Cast', [CAST_IN], dict(to=to), name=name)
_add('Cast', [np.asarray([2.7, -2.7, 1e6, -1e6], np.float32)], dict(to=7),
     name='int64-in-range')
_add('Cast', [_i([3, -2, 7])], dict(to=1), name='host-int-to-float')
_add('CumSum', [_f(rng, 3, 6), _i(1)], jax=SUM, name='axis1')
_add('CumSum', [_f(rng, 4, 3), _i([0])], jax=SUM, name='axis0')
_add('OneHot', [_i([[0, 2], [-1, 5]]), _i(4),
                np.asarray([-1.0, 3.0], np.float32)], dict(axis=-1),
     name='last')
_add('OneHot', [_i([1, 0, 3]), _i([4]), np.asarray([0.0, 1.0], np.float32)],
     dict(axis=0), name='axis0')

# ----------------------------------------------------- resize and upsample
rng = _r(190)
R = _f(rng, 1, 2, 6, 8)
EMPTY = np.zeros(0, np.float32)
for mode in ('nearest', 'linear', 'cubic'):
    for label, scales in (('up', [1, 1, 2, 2]), ('down', [1, 1, 0.5, 0.5]),
                          ('mixed', [1, 1, 1.5, 0.75])):
        _add('Resize', [R, EMPTY, np.asarray(scales, np.float32)],
             dict(mode=mode), host=(1, 2), jax=SUM,
             card=EXACT if mode == 'nearest' else SUM,
             name=f'{mode}-{label}')
    _add('Resize', [R, EMPTY, EMPTY, _i([1, 2, 9, 5])], dict(mode=mode),
         host=(1, 2), jax=SUM, card=EXACT if mode == 'nearest' else SUM,
         name=f'{mode}-sizes')
for mode in ('linear', 'cubic'):
    for label, sizes in (('up', [1, 2, 11, 15]), ('down', [1, 2, 4, 3])):
        _add('Resize', [R, EMPTY, EMPTY, _i(sizes)],
             dict(mode=mode, coordinate_transformation_mode='align_corners'),
             host=(1, 2), jax=SUM, name=f'{mode}-align-corners-{label}')
_add('Resize', [R, EMPTY, np.asarray([1, 1, 2, 2], np.float32)],
     dict(mode='nearest', coordinate_transformation_mode='asymmetric'),
     host=(1, 2), name='asymmetric-ignored')
_add('Upsample', [R, np.asarray([1, 1, 2, 3], np.float32)],
     dict(mode='nearest'), host=(1,))
_add('Interp', [R, EMPTY, np.asarray([1, 1, 2, 2], np.float32)],
     dict(mode='linear'), host=(1, 2), jax=SUM, card=SUM)
_add('Resize', [R, EMPTY, np.asarray([1, 1, 2, 2], np.float32)],
     dict(mode='linear'), host=(1, 2), platform='NXP_INT8', name='nxp')
_add('Resize', [R, EMPTY, EMPTY, _i([1, 2, 3, 12])],
     dict(mode='cubic', coordinate_transformation_mode='align_corners'),
     host=(1, 2), platform='NXP_INT8', name='nxp-align-corners')

# ----------------------------------------------------------- reductions
rng = _r(200)
M = _f(rng, 3, 4, 5)
for t in ('ReduceMean', 'ReduceSum', 'ReduceMax', 'ReduceMin', 'ReduceProd',
          'ReduceL2', 'ReduceL1', 'ReduceSumSquare'):
    tol = EXACT if t in ('ReduceMax', 'ReduceMin') else SUM
    _add(t, [M], dict(axes=[1], keepdims=1), jax=tol, name='axis1')
    _add(t, [M], dict(axes=[0, -1], keepdims=0), jax=tol, name='two-axes')
    _add(t, [M, _i([2])], jax=tol, name='axes-input')
    _add(t, [M], dict(keepdims=0), jax=tol, name='all')
TIES = np.asarray([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, -1.0, 2.0]], np.float32)
for t in ('ArgMax', 'ArgMin'):
    _add(t, [TIES], dict(axis=1, keepdims=1), name='ties-keep')
    _add(t, [M], dict(axis=0, keepdims=0), name='axis0')
_add('CaffeArgMax', [M], dict(axis=1))

# ------------------------------------------------------- host (SOI) ops
_add('Shape', [M], name='all')
_add('Shape', [M], dict(start=1, end=-1), name='start-end')
_add('Size', [M])
_add('ConstantOfShape', [_i([2, 3])],
     dict(value=np.asarray([1.5], np.float32)), name='float')
_add('ConstantOfShape', [_i([4])], name='default')
_add('Range', [_i(1), _i(10), _i(3)], name='int')
_add('Range', [np.asarray(0.5, np.float32), np.asarray(2.0, np.float32),
               np.asarray(0.25, np.float32)], host=(0, 1, 2), name='float')
_add('Constant', [], dict(value=np.asarray([[1.0, 2.0]], np.float32)))
_add('Parameter', [], dict(value=np.asarray([3, 4], np.int64)))

# ------------------------------------------------ data-dependent and detection
rng = _r(210)
NZ = np.asarray([[0.0, 1.5, 0.0], [2.0, 0.0, -1.0]], np.float32)
_add('NonZero', [NZ])
TOPK = np.asarray([[3.0, 1.0, 3.0, 2.0, 3.0, 0.0],
                   [1.0, 1.0, 1.0, 1.0, 5.0, 1.0]], np.float32)
_add('TopK', [TOPK, _i([3])], dict(axis=-1, largest=1), n_out=2,
     name='ties-largest')
_add('TopK', [TOPK, _i([4])], dict(axis=-1, largest=0), n_out=2,
     name='ties-smallest')
_add('TopK', [TOPK.T.copy(), _i([2])], dict(axis=0), n_out=2,
     name='ties-axis0')
_add('TopK', [_f(rng, 3, 7), _i([5])], n_out=2, name='random')
BOXES = np.asarray([[[0, 0, 1, 1], [0, 0.1, 1, 1.1], [0, -0.1, 1, 0.9],
                     [0, 10, 1, 11], [0, 10.1, 1, 11.1], [0, 100, 1, 101]]],
                   np.float32)
SCORES = np.asarray([[[0.9, 0.75, 0.6, 0.95, 0.5, 0.3],
                      [0.1, 0.2, 0.9, 0.4, 0.8, 0.05]]], np.float32)
_add('NonMaxSuppression', [BOXES, SCORES, _i([3]),
                           np.asarray([0.5], np.float32),
                           np.asarray([0.0], np.float32)],
     host=(3, 4), name='corners')
_add('NonMaxSuppression', [BOXES, SCORES, _i([2]),
                           np.asarray([0.5], np.float32)],
     dict(center_point_box=1), host=(3,), name='centers')
_add('NonMaxSuppression', [BOXES, SCORES], name='one-a-class')
FEAT = _f(rng, 2, 3, 10, 12)
ROIS = np.asarray([[1.0, 1.5, 6.0, 7.0], [0.0, 0.0, 11.0, 9.0],
                   [2.5, 3.0, 4.0, 3.5]], np.float32)
_add('RoiAlign', [FEAT, ROIS, _i([0, 1, 1])],
     dict(output_height=2, output_width=3, sampling_ratio=2), jax=SUM,
     name='ratio2')
_add('RoiAlign', [FEAT, ROIS * 2, _i([1, 0, 0])],
     dict(output_height=3, output_width=2, spatial_scale=0.5), jax=SUM,
     name='scaled')
_add('MMCVRoiAlign', [FEAT, ROIS], dict(output_height=2, output_width=2),
     jax=SUM)
GRID = (rng.rand(2, 4, 5, 2).astype(np.float32) * 2.4 - 1.2)
for align in (0, 1):
    _add('GridSample', [FEAT, GRID], dict(align_corners=align), jax=SUM,
         name=f'align{align}')
_add('grid_sampler', [FEAT, GRID], jax=SUM)

# ------------------------------------------------------------- recurrent
rng = _r(220)
Tn, Nn, In, Hn = 5, 3, 4, 3
LX = _f(rng, Tn, Nn, In)
LW = _f(rng, 1, 4 * Hn, In, scale=0.4)
LR = _f(rng, 1, 4 * Hn, Hn, scale=0.4)
LB = _f(rng, 1, 8 * Hn, scale=0.2)
SEQ = np.asarray([5, 3, 1], np.int32)
_add('LSTM', [LX, LW, LR, LB], dict(hidden_size=Hn), n_out=3, jax=LOOP,
     name='forward')
_add('LSTM', [LX, LW, LR, LB, SEQ], dict(hidden_size=Hn), n_out=3,
     jax=LOOP, name='sequence-lens')
_add('LSTM', [LX, np.concatenate([LW, LW * 0.5]),
              np.concatenate([LR, LR * 0.5]), np.concatenate([LB, LB * 0.5]),
              SEQ], dict(hidden_size=Hn, direction='bidirectional'),
     n_out=3, jax=LOOP, name='bidirectional-sequence-lens')
_add('LSTM', [LX, LW, LR, LB], dict(hidden_size=Hn,
                                    activations=['Sigmoid', 'Relu', 'Relu'],
                                    clip=0.8),
     n_out=3, jax=LOOP, name='activations-clip')
_add('LSTM', [LX, LW, LR, LB, np.full(3, 5, np.int32), _f(rng, 1, Nn, Hn),
              _f(rng, 1, Nn, Hn)], dict(hidden_size=Hn), n_out=3, jax=LOOP,
     name='initial-states')
_add('LSTM', [LX, np.concatenate([LW, LW]), np.concatenate([LR, LR])],
     dict(hidden_size=Hn, direction='bidirectional',
          activations=['HardSigmoid', 'Softsign', 'Elu', 'Sigmoid',
                       'Softplus', 'LeakyRelu']),
     n_out=3, jax=LOOP, name='other-activations')
GW = _f(rng, 1, 3 * Hn, In, scale=0.4)
GR = _f(rng, 1, 3 * Hn, Hn, scale=0.4)
GB = _f(rng, 1, 6 * Hn, scale=0.2)
for lbr in (0, 1):
    _add('GRU', [LX, GW, GR, GB], dict(hidden_size=Hn,
                                       linear_before_reset=lbr),
         n_out=2, jax=LOOP, name=f'lbr{lbr}')
_add('GRU', [LX, np.concatenate([GW, GW * 0.7]),
             np.concatenate([GR, GR * 0.7]), np.concatenate([GB, GB]),
             np.zeros(0, np.int32), _f(rng, 2, Nn, Hn)],
     dict(hidden_size=Hn, direction='bidirectional'), n_out=2, jax=LOOP,
     name='bidirectional-initial')

# ------------------------------------------------------------- attention
rng = _r(230)
AX = _f(rng, 2, 6, 8)
MASK = np.asarray([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], np.int64)
_add('Attention', [AX, _f(rng, 8, 24, scale=0.3), _f(rng, 24, scale=0.1),
                   MASK], dict(num_heads=2), jax=LOOP, name='qkv-mask')
_add('Attention', [AX, _f(rng, 8, 24, scale=0.3), _f(rng, 24, scale=0.1)],
     dict(num_heads=4), jax=LOOP, name='qkv')
_add('Attention', [_f(rng, 2, 2, 6, 4), _f(rng, 2, 2, 4, 6),
                   _f(rng, 2, 2, 6, 4)], dict(scale=0.5), jax=LOOP,
     name='fused-product')
_add('MultiHeadAttention', [AX, AX, AX, MASK], dict(num_heads=2), jax=LOOP,
     name='projected-mask')
_add('MultiHeadAttention', [AX, AX, AX] + [_f(rng, 8, 8, scale=0.3)
                                           for _ in range(4)]
     + [_f(rng, 8, scale=0.1) for _ in range(4)], dict(num_heads=4),
     jax=LOOP, name='weights-biases')
_add('MultiHeadAttention', [AX, AX, AX] + [_f(rng, 8, 8, scale=0.3)
                                           for _ in range(4)],
     dict(num_heads=2), jax=LOOP, name='weights')

# ------------------------------------------------------------ the rest
rng = _r(240)
_add('Dropout', [_f(rng, 3, 4)])
_add('Scale', [_f(rng, 2, 3, 4, 4), _f(rng, 3), _f(rng, 3)], name='bias')
_add('Scale', [_f(rng, 2, 3, 4, 4), _f(rng, 3)], name='no-bias')
Qx = _f(rng, 2, 3, 4, scale=2)
_add('QuantizeLinear', [Qx, np.asarray(0.02, np.float32),
                        np.asarray(3, np.int8)], name='tensor')
_add('QuantizeLinear', [Qx, np.asarray([0.01, 0.02, 0.03], np.float32),
                        np.asarray([0, 2, -1], np.int8)], dict(axis=1),
     name='axis')
_add('DequantizeLinear', [np.asarray([[-128, 0, 5, 127]], np.int8),
                          np.asarray(0.05, np.float32),
                          np.asarray(1, np.int8)], name='tensor')
_add('QuantizeFloating', [Qx, np.asarray(0.01, np.float32)],
     name='e4m3')
_add('DequantizeFloating', [Qx, np.asarray(0.5, np.float32),
                            np.asarray(0.25, np.float32)])
_add('PPQDeviceSwitch', [Qx], dict(direction='to_host'))


# ---------------------------------------------------------------- running
def port_inputs(case: Case, device=None):
    """The case's inputs as the port takes them: float arrays as tensors on
    `device` (the CPU by default), the rest as host arrays."""
    import torch
    out = []
    for i, v in enumerate(case.inputs):
        a = np.asarray(v)
        if i not in case.host and a.dtype.kind == 'f':
            out.append(torch.as_tensor(a.copy(), device=device))
        else:
            out.append(a.copy())
    return out


def run_port(case: Case, device=None, ctx=None):
    """The port's op on the case's inputs, inside `simulation_precision`
    as the executors run it (float32 products and convolutions, TF32 off),
    with an ExecContext that names `device` unless one is given: a list of
    numpy outputs."""
    import torch
    from ppq_tpu_torch.core import TargetPlatform
    from ppq_tpu_torch.executor import (ExecContext, resolve_forward,
                                        simulation_precision)
    from ppq_tpu_torch.ir import Operation
    if ctx is None:
        ctx = ExecContext(device=torch.device(device or 'cpu'))
    op = Operation(f'case_{case.id}', case.op_type, attributes=case.attrs)
    op.outputs = [None] * case.n_out
    platform = (TargetPlatform[case.platform] if case.platform
                else TargetPlatform.UNSPECIFIED)
    with torch.no_grad(), simulation_precision():
        out = resolve_forward(platform, case.op_type)(
            op, port_inputs(case, device), ctx)
    if not isinstance(out, (tuple, list)):
        out = [out]
    result = []
    for o in out:
        if isinstance(o, torch.Tensor):
            o = o.detach()
            if o.dtype in (torch.bfloat16, torch.float16):
                o = o.to(torch.float32) if o.dtype == torch.bfloat16 else o
            o = o.cpu().numpy()
        result.append(np.asarray(o))
    return result


def assert_close(got: Sequence[np.ndarray], want: Sequence[np.ndarray], tol,
                 what: str = ''):
    """Each output within `tol` (0: equal, NaN equal to NaN); integer
    outputs by value whatever their width. Returns the largest absolute
    difference."""
    assert len(got) == len(want), (what, len(got), len(want))
    worst = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        if w.dtype.kind in 'iub':
            assert g.dtype.kind in 'iub', (what, k, g.dtype, w.dtype)
            g, w = g.astype(np.int64), w.astype(np.int64)
        else:
            assert g.dtype.kind == 'f', (what, k, g.dtype, w.dtype)
            g, w = g.astype(np.float64), w.astype(np.float64)
        if g.size:
            finite = np.isfinite(g) & np.isfinite(w)
            if finite.any():
                worst = max(worst, float(np.max(np.abs(g[finite]
                                                       - w[finite]))))
        if tol == EXACT:
            assert np.array_equal(g, w, equal_nan=w.dtype.kind == 'f'), \
                (what, k, np.max(np.abs(g - w)) if g.size else None)
        else:
            np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1],
                                       err_msg=f'{what} output {k}')
    return worst
