from .command import (DefaultGraphProcessor, GraphCommand, GraphCommandProcessor,
                      GraphCommandType, QuantableGraphProcessor,
                      QuantizeOperationCommand, default_command_chain)
from .graph import (BaseGraph, GraphBuilder, GraphExporter, Operation, Opset,
                    Variable)
from .morph import (GraphDecomposer, GraphFormatter, GraphMerger,
                    decompose_gemm, decompose_gru, delete_isolated,
                    format_graph, fuse_bn, fuse_bias_add, fuse_gelu,
                    fuse_layernorm, fuse_matmul_add, fuse_scale,
                    fuse_selfattention, fuse_skiplayernorm, remove_identity,
                    truncate_on_var)
from .opdef import (OpSocket, VLink, fp32_input_indices, socket_of,
                    soi_input_indices)
from .quantize import (QuantableOperation, dequantize_graph,
                       quantize_operation, restore_graph_quantization)
from .search import (GraphPattern, OperationSet, Path, SearchableGraph,
                     TraversalCommand)
