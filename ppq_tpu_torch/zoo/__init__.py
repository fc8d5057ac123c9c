"""Model zoo: deterministic ONNX-semantic models, the same graphs with the
same names and seeded numpy weights as ppq_tpu.zoo. This slice carries the
vision family of the main path."""

from .builder import NetBuilder
from .vision import (mobilenet_v2, resnet18, resnext_lite,
                     se_resnet_lite, shufflenet_v2_lite, tiny_cnn)

__all__ = ['NetBuilder', 'mobilenet_v2', 'resnet18', 'resnext_lite',
           'se_resnet_lite', 'shufflenet_v2_lite', 'tiny_cnn']
