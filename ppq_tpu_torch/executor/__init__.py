from .base import (OPERATION_FORWARD_TABLE, BaseGraphExecutor,
                   QuantRuntimeHook, RuntimeHook, register_operation_handler,
                   resolve_forward)
from .executor import QuantizeDelegator, TorchExecutor, resolve_device
from .ops.default import (DEFAULT_BACKEND_TABLE, ExecContext,
                          simulation_precision)
