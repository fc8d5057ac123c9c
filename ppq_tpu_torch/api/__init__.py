from .interface import (DEQUANTIZE_GRAPH, dispatch_graph, format_graph,
                        manop, quantize_graph)
from .setting import (QuantizationSetting, QuantizationSettingFactory,
                      UnbelievableUserFriendlyQuantizationSetting)

__all__ = [
    'DEQUANTIZE_GRAPH', 'dispatch_graph', 'format_graph', 'manop',
    'quantize_graph', 'QuantizationSetting', 'QuantizationSettingFactory',
    'UnbelievableUserFriendlyQuantizationSetting',
]
