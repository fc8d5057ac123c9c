# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# The schema of ppq_tpu's onnx_pb2.py, registered as ppq_tpu_torch_onnx.proto
# (package ppq_tpu_torch_onnx) so that both packages load in one process;
# the wire and text formats do not depend on these names.
# source: onnx.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x18ppq_tpu_torch_onnx.proto\x12\x12ppq_tpu_torch_onnx"\xee\x04\n\x0eAttributeProto\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x15\n\rref_attr_name\x18\x15 \x01(\t\x12\x12\n\ndoc_string\x18\r \x01(\t\x12>\n\x04type\x18\x14 \x01(\x0e20.ppq_tpu_torch_onnx.AttributeProto.AttributeType\x12\t\n\x01f\x18\x02 \x01(\x02\x12\t\n\x01i\x18\x03 \x01(\x03\x12\t\n\x01s\x18\x04 \x01(\x0c\x12*\n\x01t\x18\x05 \x01(\x0b2\x1f.ppq_tpu_torch_onnx.TensorProto\x12)\n\x01g\x18\x06 \x01(\x0b2\x1e.ppq_tpu_torch_onnx.GraphProto\x12\x0e\n\x06floats\x18\x07 \x03(\x02\x12\x0c\n\x04ints\x18\x08 \x03(\x03\x12\x0f\n\x07strings\x18\t \x03(\x0c\x120\n\x07tensors\x18\n \x03(\x0b2\x1f.ppq_tpu_torch_onnx.TensorProto\x12.\n\x06graphs\x18\x0b \x03(\x0b2\x1e.ppq_tpu_torch_onnx.GraphProto"\xd9\x01\n\rAttributeType\x12\r\n\tUNDEFINED\x10\x00\x12\t\n\x05FLOAT\x10\x01\x12\x07\n\x03INT\x10\x02\x12\n\n\x06STRING\x10\x03\x12\n\n\x06TENSOR\x10\x04\x12\t\n\x05GRAPH\x10\x05\x12\x11\n\rSPARSE_TENSOR\x10\x0b\x12\x0e\n\nTYPE_PROTO\x10\r\x12\n\n\x06FLOATS\x10\x06\x12\x08\n\x04INTS\x10\x07\x12\x0b\n\x07STRINGS\x10\x08\x12\x0b\n\x07TENSORS\x10\t\x12\n\n\x06GRAPHS\x10\n\x12\x12\n\x0eSPARSE_TENSORS\x10\x0c\x12\x0f\n\x0bTYPE_PROTOS\x10\x0e"_\n\x0eValueInfoProto\x12\x0c\n\x04name\x18\x01 \x01(\t\x12+\n\x04type\x18\x02 \x01(\x0b2\x1d.ppq_tpu_torch_onnx.TypeProto\x12\x12\n\ndoc_string\x18\x03 \x01(\t"\xa4\x01\n\tNodeProto\x12\r\n\x05input\x18\x01 \x03(\t\x12\x0e\n\x06output\x18\x02 \x03(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\x12\x0f\n\x07op_type\x18\x04 \x01(\t\x12\x0e\n\x06domain\x18\x07 \x01(\t\x125\n\tattribute\x18\x05 \x03(\x0b2".ppq_tpu_torch_onnx.AttributeProto\x12\x12\n\ndoc_string\x18\x06 \x01(\t"\xbd\x02\n\nModelProto\x12\x12\n\nir_version\x18\x01 \x01(\x03\x12<\n\x0copset_import\x18\x08 \x03(\x0b2&.ppq_tpu_torch_onnx.OperatorSetIdProto\x12\x15\n\rproducer_name\x18\x02 \x01(\t\x12\x18\n\x10producer_version\x18\x03 \x01(\t\x12\x0e\n\x06domain\x18\x04 \x01(\t\x12\x15\n\rmodel_version\x18\x05 \x01(\x03\x12\x12\n\ndoc_string\x18\x06 \x01(\t\x12-\n\x05graph\x18\x07 \x01(\x0b2\x1e.ppq_tpu_torch_onnx.GraphProto\x12B\n\x0emetadata_props\x18\x0e \x03(\x0b2*.ppq_tpu_torch_onnx.StringStringEntryProto"4\n\x16StringStringEntryProto\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t"\xb0\x02\n\nGraphProto\x12+\n\x04node\x18\x01 \x03(\x0b2\x1d.ppq_tpu_torch_onnx.NodeProto\x12\x0c\n\x04name\x18\x02 \x01(\t\x124\n\x0binitializer\x18\x05 \x03(\x0b2\x1f.ppq_tpu_torch_onnx.TensorProto\x12\x12\n\ndoc_string\x18\n \x01(\t\x121\n\x05input\x18\x0b \x03(\x0b2".ppq_tpu_torch_onnx.ValueInfoProto\x122\n\x06output\x18\x0c \x03(\x0b2".ppq_tpu_torch_onnx.ValueInfoProto\x126\n\nvalue_info\x18\r \x03(\x0b2".ppq_tpu_torch_onnx.ValueInfoProto"\x98\x04\n\x0bTensorProto\x12\x0c\n\x04dims\x18\x01 \x03(\x03\x12\x11\n\tdata_type\x18\x02 \x01(\x05\x12\x16\n\nfloat_data\x18\x04 \x03(\x02B\x02\x10\x01\x12\x16\n\nint32_data\x18\x05 \x03(\x05B\x02\x10\x01\x12\x13\n\x0bstring_data\x18\x06 \x03(\x0c\x12\x16\n\nint64_data\x18\x07 \x03(\x03B\x02\x10\x01\x12\x0c\n\x04name\x18\x08 \x01(\t\x12\x12\n\ndoc_string\x18\x0c \x01(\t\x12\x10\n\x08raw_data\x18\t \x01(\x0c\x12\x17\n\x0bdouble_data\x18\n \x03(\x01B\x02\x10\x01\x12\x17\n\x0buint64_data\x18\x0b \x03(\x04B\x02\x10\x01"\xa4\x02\n\x08DataType\x12\r\n\tUNDEFINED\x10\x00\x12\t\n\x05FLOAT\x10\x01\x12\t\n\x05UINT8\x10\x02\x12\x08\n\x04INT8\x10\x03\x12\n\n\x06UINT16\x10\x04\x12\t\n\x05INT16\x10\x05\x12\t\n\x05INT32\x10\x06\x12\t\n\x05INT64\x10\x07\x12\n\n\x06STRING\x10\x08\x12\x08\n\x04BOOL\x10\t\x12\x0b\n\x07FLOAT16\x10\n\x12\n\n\x06DOUBLE\x10\x0b\x12\n\n\x06UINT32\x10\x0c\x12\n\n\x06UINT64\x10\r\x12\r\n\tCOMPLEX64\x10\x0e\x12\x0e\n\nCOMPLEX128\x10\x0f\x12\x0c\n\x08BFLOAT16\x10\x10\x12\x10\n\x0cFLOAT8E4M3FN\x10\x11\x12\x12\n\x0eFLOAT8E4M3FNUZ\x10\x12\x12\x0e\n\nFLOAT8E5M2\x10\x13\x12\x12\n\x0eFLOAT8E5M2FNUZ\x10\x14"\xa3\x01\n\x10TensorShapeProto\x12;\n\x03dim\x18\x01 \x03(\x0b2..ppq_tpu_torch_onnx.TensorShapeProto.Dimension\x1aR\n\tDimension\x12\x13\n\tdim_value\x18\x01 \x01(\x03H\x00\x12\x13\n\tdim_param\x18\x02 \x01(\tH\x00\x12\x12\n\ndenotation\x18\x03 \x01(\tB\x07\n\x05value"\xb7\x01\n\tTypeProto\x12;\n\x0btensor_type\x18\x01 \x01(\x0b2$.ppq_tpu_torch_onnx.TypeProto.TensorH\x00\x12\x12\n\ndenotation\x18\x06 \x01(\t\x1aP\n\x06Tensor\x12\x11\n\telem_type\x18\x01 \x01(\x05\x123\n\x05shape\x18\x02 \x01(\x0b2$.ppq_tpu_torch_onnx.TensorShapeProtoB\x07\n\x05value"5\n\x12OperatorSetIdProto\x12\x0e\n\x06domain\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\x03b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ppq_tpu_torch.frontends.onnx.onnx_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TENSORPROTO.fields_by_name['float_data']._options = None
  _TENSORPROTO.fields_by_name['float_data']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['int32_data']._options = None
  _TENSORPROTO.fields_by_name['int32_data']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['int64_data']._options = None
  _TENSORPROTO.fields_by_name['int64_data']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['double_data']._options = None
  _TENSORPROTO.fields_by_name['double_data']._serialized_options = b'\020\001'
  _TENSORPROTO.fields_by_name['uint64_data']._options = None
  _TENSORPROTO.fields_by_name['uint64_data']._serialized_options = b'\020\001'
  _ATTRIBUTEPROTO._serialized_start=49
  _ATTRIBUTEPROTO._serialized_end=671
  _ATTRIBUTEPROTO_ATTRIBUTETYPE._serialized_start=454
  _ATTRIBUTEPROTO_ATTRIBUTETYPE._serialized_end=671
  _VALUEINFOPROTO._serialized_start=673
  _VALUEINFOPROTO._serialized_end=768
  _NODEPROTO._serialized_start=771
  _NODEPROTO._serialized_end=935
  _MODELPROTO._serialized_start=938
  _MODELPROTO._serialized_end=1255
  _STRINGSTRINGENTRYPROTO._serialized_start=1257
  _STRINGSTRINGENTRYPROTO._serialized_end=1309
  _GRAPHPROTO._serialized_start=1312
  _GRAPHPROTO._serialized_end=1616
  _TENSORPROTO._serialized_start=1619
  _TENSORPROTO._serialized_end=2155
  _TENSORPROTO_DATATYPE._serialized_start=1863
  _TENSORPROTO_DATATYPE._serialized_end=2155
  _TENSORSHAPEPROTO._serialized_start=2158
  _TENSORSHAPEPROTO._serialized_end=2321
  _TENSORSHAPEPROTO_DIMENSION._serialized_start=2239
  _TENSORSHAPEPROTO_DIMENSION._serialized_end=2321
  _TYPEPROTO._serialized_start=2324
  _TYPEPROTO._serialized_end=2507
  _TYPEPROTO_TENSOR._serialized_start=2418
  _TYPEPROTO_TENSOR._serialized_end=2498
  _OPERATORSETIDPROTO._serialized_start=2509
  _OPERATORSETIDPROTO._serialized_end=2562
# @@protoc_insertion_point(module_scope)
