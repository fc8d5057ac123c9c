from .common import *  # noqa: F401,F403
from .config import PPQ_TPU_CONFIG
from .defs import (PPQLogger, SingletonMeta, ppq_debug, ppq_error, ppq_info,
                   ppq_warning, timed)
from .qtypes import (QP, DataType, QuantizationPolicy, QuantizationProperty,
                     QuantizationStates, QuantizationVisibility,
                     RoundingPolicy, TargetPlatform)
from .storage import dump_native, dumps_native, load_native, loads_native
from .tqc import OperationQuantizationConfig, TensorQuantizationConfig
