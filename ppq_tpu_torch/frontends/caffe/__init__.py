from . import caffe_pb2
from .parser import CaffeParser, load_caffe_graph
from .exporter import (CaffeExporter, PPLDSPCaffeExporter,
                       PPLDSPTICaffeExporter, SNPECaffeExporter)

__all__ = ['caffe_pb2', 'CaffeParser', 'CaffeExporter', 'load_caffe_graph',
           'PPLDSPCaffeExporter', 'PPLDSPTICaffeExporter',
           'SNPECaffeExporter']
