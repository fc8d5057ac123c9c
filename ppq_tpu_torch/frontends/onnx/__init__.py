from . import onnx_pb2
from .parser import OnnxParser, load_onnx_graph
from .exporter import OnnxExporter, graph_to_model_proto
