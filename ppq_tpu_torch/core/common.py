"""Global constants and op-class sets (capability parity with
ppq/core/common.py:10-115)."""

# ----------------------------------------------------------------- observers
OBSERVER_MIN_SCALE = 1e-8                 # scale underflow floor
OBSERVER_MIN_SCALE_MANUL_OVERRIDE = 'OBSERVER_MIN_SCALE_MANUL_OVERRIDE'
OBSERVER_KL_HIST_BINS = 4096              # KL histogram resolution
OBSERVER_KL_HIST_BINS_MANUL_OVERRIDE = 'OBSERVER_KL_HIST_BINS_MANUL_OVERRIDE'
OBSERVER_PERCENTILE = 0.9999
OBSERVER_PERCENTILE_MANUL_OVERRIDE = 'OBSERVER_PERCENTILE_MANUL_OVERRIDE'
OBSERVER_MSE_HIST_BINS = 2048
OBSERVER_MSE_COMPUTE_INTERVAL = 8
OBSERVER_ISOTONE_AXIS = 'OBSERVER_ISOTONE_AXIS'
OBSERVER_FLOATING_MSE_FETCHES = 4096

# ------------------------------------------------------------------- op sets
# ops whose parameters are quantized passively (share scale with activation)
PASSIVE_OPERATIONS = {
    'MaxPool', 'GlobalMaxPool', 'Reshape', 'Flatten', 'Identity', 'Dropout',
    'Slice', 'Pad', 'Split', 'Transpose', 'Interp', 'Squeeze', 'Unsqueeze',
    'Resize', 'Expand', 'Repeat', 'GatherElements', 'ScatterND', 'Tile',
}

# ops holding the network's weights — the compute backbone
COMPUTING_OP = {'Conv', 'Gemm', 'ConvTranspose', 'MatMul'}

# ops generating shape-or-index (SOI) values
SOI_OP = {'Shape', 'NonZero', 'TopK', 'NonMaxSuppression', 'ConstantOfShape'}

# ops whose multiple inputs/outputs must share aligned scales
TYPES_FOR_ALIGNMENT = {
    'Elementwise': {'Add', 'Sub', 'Sum'},
    'Concat': {'Concat'},
    'Pooling': {'MaxPool', 'GlobalMaxPool', 'AveragePool', 'GlobalAveragePool',
                'Resize', 'Split', 'Slice', 'Pad'},
}

# linear activations fusable into a preceding computing op on most backends
LINEAR_ACTIVATIONS = {'Relu', 'Clip', 'LeakyRelu', 'PRelu'}

# default ONNX opset the exporters emit
ONNX_EXPORT_OPSET = 13
ONNX_VERSION = 8
DEFAULT_OPSET_DOMAIN = ''
DEFAULT_OPSET_VERSION = 13

STRICT_OPSET_CHECKING = False

# name of the attribute carrying pre-computed values on Constant ops
CONSTANT_VALUE_ATTRIB = 'value'

# executor
EXECUTOR_FUSION_SENTINEL = '_ppq_tpu_fused'

# calibration defaults
CALIBRATION_BATCHES_DEFAULT = 32
