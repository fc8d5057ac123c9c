"""Model zoo: deterministic ONNX-semantic models, the same graphs with the
same names and seeded numpy weights as ppq_tpu.zoo (the vision,
transformer, detection and segmentation families), and the evaluation
harnesses of `zoo/evaluate.py` (top-k accuracy, the QuantZoo errors)."""

from .builder import NetBuilder
from .detection import yolo_lite
from .segmentation import deeplab_lite, srcnn, unet_lite
from .transformer import bert_encoder, crnn_ocr, mha_fused_encoder
from .vision import (mobilenet_v2, resnet18, resnext_lite,
                     se_resnet_lite, shufflenet_v2_lite, tiny_cnn)

__all__ = ['NetBuilder', 'yolo_lite', 'bert_encoder', 'crnn_ocr',
           'mha_fused_encoder', 'mobilenet_v2', 'resnet18', 'tiny_cnn',
           'deeplab_lite', 'srcnn', 'unet_lite', 'se_resnet_lite',
           'resnext_lite', 'shufflenet_v2_lite']
