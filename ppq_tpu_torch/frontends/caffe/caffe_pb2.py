# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# The schema of ppq_tpu's caffe_pb2.py, registered as ppq_tpu_torch_caffe.proto
# (package ppq_tpu_torch_caffe) so that both packages load in one process;
# the wire and text formats do not depend on these names.
# source: ppq_tpu_caffe.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x19ppq_tpu_torch_caffe.proto\x12\x13ppq_tpu_torch_caffe"\x1c\n\tBlobShape\x12\x0f\n\x03dim\x18\x01 \x03(\x03B\x02\x10\x01"\xa8\x01\n\tBlobProto\x12-\n\x05shape\x18\x07 \x01(\x0b2\x1e.ppq_tpu_torch_caffe.BlobShape\x12\x10\n\x04data\x18\x05 \x03(\x02B\x02\x10\x01\x12\x10\n\x04diff\x18\x06 \x03(\x02B\x02\x10\x01\x12\x0e\n\x03num\x18\x01 \x01(\x05:\x010\x12\x13\n\x08channels\x18\x02 \x01(\x05:\x010\x12\x11\n\x06height\x18\x03 \x01(\x05:\x010\x12\x10\n\x05width\x18\x04 \x01(\x05:\x010";\n\x0fFillerParameter\x12\x16\n\x04type\x18\x01 \x01(\t:\x08constant\x12\x10\n\x05value\x18\x02 \x01(\x02:\x010"\xa7\x01\n\x0cNetParameter\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05input\x18\x03 \x03(\t\x123\n\x0binput_shape\x18\x08 \x03(\x0b2\x1e.ppq_tpu_torch_caffe.BlobShape\x12\x11\n\tinput_dim\x18\x04 \x03(\x05\x122\n\x05layer\x18d \x03(\x0b2#.ppq_tpu_torch_caffe.LayerParameter"\x90\x03\n\x14ConvolutionParameter\x12>\n\x0equantize_param\x18J \x01(\x0b2&.ppq_tpu_torch_caffe.QuantizeParameter\x12I\n\x19perchannel_quantize_param\x18K \x03(\x0b2&.ppq_tpu_torch_caffe.QuantizeParameter\x12\x12\n\nnum_output\x18\x01 \x01(\r\x12\x17\n\tbias_term\x18\x02 \x01(\x08:\x04true\x12\x0b\n\x03pad\x18\x03 \x03(\r\x12\x13\n\x0bkernel_size\x18\x04 \x03(\r\x12\x0e\n\x06stride\x18\x06 \x03(\r\x12\x10\n\x08dilation\x18\x12 \x03(\r\x12\x10\n\x05pad_h\x18\t \x01(\r:\x010\x12\x10\n\x05pad_w\x18\n \x01(\r:\x010\x12\x10\n\x08kernel_h\x18\x0b \x01(\r\x12\x10\n\x08kernel_w\x18\x0c \x01(\r\x12\x10\n\x08stride_h\x18\r \x01(\r\x12\x10\n\x08stride_w\x18\x0e \x01(\r\x12\x10\n\x05group\x18\x05 \x01(\r:\x011"\xe3\x02\n\x10PoolingParameter\x12C\n\x04pool\x18\x01 \x01(\x0e20.ppq_tpu_torch_caffe.PoolingParameter.PoolMethod:\x03MAX\x12\x0e\n\x03pad\x18\x04 \x01(\r:\x010\x12\x10\n\x05pad_h\x18\t \x01(\r:\x010\x12\x10\n\x05pad_w\x18\n \x01(\r:\x010\x12\x13\n\x0bkernel_size\x18\x02 \x01(\r\x12\x10\n\x08kernel_h\x18\x05 \x01(\r\x12\x10\n\x08kernel_w\x18\x06 \x01(\r\x12\x11\n\x06stride\x18\x03 \x01(\r:\x011\x12\x10\n\x08stride_h\x18\x07 \x01(\r\x12\x10\n\x08stride_w\x18\x08 \x01(\r\x12\x1d\n\x0eglobal_pooling\x18\x0c \x01(\x08:\x05false\x12\x17\n\tceil_mode\x18\r \x01(\x08:\x04true".\n\nPoolMethod\x12\x07\n\x03MAX\x10\x00\x12\x07\n\x03AVE\x10\x01\x12\x0e\n\nSTOCHASTIC\x10\x02"\xfa\x01\n\x15InnerProductParameter\x12\x12\n\nnum_output\x18\x01 \x01(\r\x12\x17\n\tbias_term\x18\x02 \x01(\x08:\x04true\x12\x0f\n\x04axis\x18\x05 \x01(\x05:\x011\x12\x18\n\ttranspose\x18\x06 \x01(\x08:\x05false\x12>\n\x0equantize_param\x18\x08 \x01(\x0b2&.ppq_tpu_torch_caffe.QuantizeParameter\x12I\n\x19perchannel_quantize_param\x18\t \x03(\x0b2&.ppq_tpu_torch_caffe.QuantizeParameter"*\n\rReLUParameter\x12\x19\n\x0enegative_slope\x18\x01 \x01(\x02:\x010"\x93\x01\n\x10EltwiseParameter\x12G\n\toperation\x18\x01 \x01(\x0e2/.ppq_tpu_torch_caffe.EltwiseParameter.EltwiseOp:\x03SUM\x12\r\n\x05coeff\x18\x02 \x03(\x02"\'\n\tEltwiseOp\x12\x08\n\x04PROD\x10\x00\x12\x07\n\x03SUM\x10\x01\x12\x07\n\x03MAX\x10\x02""\n\x0fConcatParameter\x12\x0f\n\x04axis\x18\x02 \x01(\x05:\x011"#\n\x10SoftmaxParameter\x12\x0f\n\x04axis\x18\x02 \x01(\x05:\x011"j\n\x12BatchNormParameter\x12\x18\n\x10use_global_stats\x18\x01 \x01(\x08\x12&\n\x17moving_average_fraction\x18\x02 \x01(\x02:\x050.999\x12\x12\n\x03eps\x18\x03 \x01(\x02:\x051e-05"P\n\x0eScaleParameter\x12\x0f\n\x04axis\x18\x01 \x01(\x05:\x011\x12\x13\n\x08num_axes\x18\x02 \x01(\x05:\x011\x12\x18\n\tbias_term\x18\x04 \x01(\x08:\x05false"h\n\x10ReshapeParameter\x12-\n\x05shape\x18\x01 \x01(\x0b2\x1e.ppq_tpu_torch_caffe.BlobShape\x12\x0f\n\x04axis\x18\x02 \x01(\x05:\x010\x12\x14\n\x08num_axes\x18\x03 \x01(\x05:\x02-1"9\n\x10FlattenParameter\x12\x0f\n\x04axis\x18\x01 \x01(\x05:\x011\x12\x14\n\x08end_axis\x18\x02 \x01(\x05:\x02-1"!\n\x10PermuteParameter\x12\r\n\x05order\x18\x01 \x03(\r".\n\x10DropoutParameter\x12\x1a\n\rdropout_ratio\x18\x01 \x01(\x02:\x030.5"F\n\x0ePowerParameter\x12\x10\n\x05power\x18\x01 \x01(\x02:\x011\x12\x10\n\x05scale\x18\x02 \x01(\x02:\x011\x12\x10\n\x05shift\x18\x03 \x01(\x02:\x010"h\n\x0fInterpParameter\x12\x11\n\x06height\x18\x01 \x01(\x05:\x010\x12\x10\n\x05width\x18\x02 \x01(\x05:\x010\x12\x16\n\x0bzoom_factor\x18\x03 \x01(\x05:\x011\x12\x18\n\rshrink_factor\x18\x04 \x01(\x05:\x011"%\n\x11UpsampleParameter\x12\x10\n\x05scale\x18\x01 \x01(\x05:\x012"6\n\x0eSliceParameter\x12\x0f\n\x04axis\x18\x03 \x01(\x05:\x011\x12\x13\n\x0bslice_point\x18\x02 \x03(\r"\x12\n\x10SigmoidParameter"\x0f\n\rTanHParameter"\x11\n\x0fAbsValParameter"?\n\x0eInputParameter\x12-\n\x05shape\x18\x01 \x03(\x0b2\x1e.ppq_tpu_torch_caffe.BlobShape"\xa0\x01\n\x11QuantizeParameter\x12\x16\n\x04type\x18\x01 \x01(\t:\x08quantize\x12\x11\n\x04step\x18\x02 \x01(\x02:\x030.1\x12\x14\n\trange_min\x18\x03 \x01(\x02:\x010\x12\x16\n\trange_max\x18\x04 \x01(\x02:\x03255\x12\x15\n\nzero_point\x18\x05 \x01(\r:\x010\x12\x1b\n\x0cadjust_range\x18\x06 \x01(\x08:\x05false"e\n\x0ePReLUParameter\x124\n\x06filler\x18\x01 \x01(\x0b2$.ppq_tpu_torch_caffe.FillerParameter\x12\x1d\n\x0echannel_shared\x18\x02 \x01(\x08:\x05false"M\n\x0fArgMaxParameter\x12\x1a\n\x0bout_max_val\x18\x01 \x01(\x08:\x05false\x12\x10\n\x05top_k\x18\x02 \x01(\r:\x011\x12\x0c\n\x04axis\x18\x03 \x01(\x05"2\n\rTileParameter\x12\x0f\n\x04axis\x18\x01 \x01(\x05:\x011\x12\x10\n\x05tiles\x18\x02 \x01(\x05:\x011"+\n\x17ChannelShuffleParameter\x12\x10\n\x05group\x18\x01 \x01(\r:\x011")\n\rClipParameter\x12\x0b\n\x03min\x18\x01 \x01(\x02\x12\x0b\n\x03max\x18\x02 \x01(\x02"3\n\x0fReduceParameter\x12\x0f\n\x04axis\x18\x01 \x01(\x05:\x011\x12\x0f\n\x04mode\x18\x02 \x01(\x05:\x010"X\n\x15InstanceNormParameter\x12\x14\n\x0cnum_features\x18\x01 \x01(\x05\x12\x12\n\x03eps\x18\x02 \x01(\x02:\x051e-05\x12\x15\n\x06affine\x18\x03 \x01(\x08:\x05false""\n\x0fMatMulParameter\x12\x0f\n\x04mode\x18\x01 \x01(\x05:\x011".\n\x15SubpixelDownParameter\x12\x15\n\ndownsample\x18\x01 \x01(\r:\x011"*\n\x13SubpixelUpParameter\x12\x13\n\x08upsample\x18\x03 \x01(\r:\x011"(\n\x13NNUpsampleParameter\x12\x11\n\x06resize\x18\x01 \x01(\r:\x012"S\n\x0cPadParameter\x12\x0e\n\x03pad\x18\x01 \x01(\x05:\x010\x12\x0f\n\x04mode\x18\x02 \x01(\x05:\x011\x12\x10\n\x05pad_w\x18\x03 \x01(\x05:\x010\x12\x10\n\x05pad_h\x18\x04 \x01(\x05:\x010"+\n\x0eReLU6Parameter\x12\x19\n\x0enegative_slope\x18\x01 \x01(\x02:\x010"\x80\x01\n\x12ParameterParameter\x12\x10\n\x05batch\x18\x01 \x01(\x05:\x011\x12\r\n\x01m\x18\x02 \x01(\x05:\x02-1\x12\r\n\x01n\x18\x03 \x01(\x05:\x02-1\x12\x13\n\x07channel\x18\x04 \x01(\x05:\x02-1\x12\x12\n\x06height\x18\x05 \x01(\x05:\x02-1\x12\x11\n\x05width\x18\x06 \x01(\x05:\x02-1"\xa3\x11\n\x0eLayerParameter\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\x0e\n\x06bottom\x18\x03 \x03(\t\x12\x0b\n\x03top\x18\x04 \x03(\t\x12-\n\x05blobs\x18\x07 \x03(\x0b2\x1e.ppq_tpu_torch_caffe.BlobProto\x12D\n\x11convolution_param\x18j \x01(\x0b2).ppq_tpu_torch_caffe.ConvolutionParameter\x12<\n\rpooling_param\x18y \x01(\x0b2%.ppq_tpu_torch_caffe.PoolingParameter\x12G\n\x13inner_product_param\x18u \x01(\x0b2*.ppq_tpu_torch_caffe.InnerProductParameter\x126\n\nrelu_param\x18{ \x01(\x0b2".ppq_tpu_torch_caffe.ReLUParameter\x12<\n\reltwise_param\x18n \x01(\x0b2%.ppq_tpu_torch_caffe.EltwiseParameter\x12:\n\x0cconcat_param\x18h \x01(\x0b2$.ppq_tpu_torch_caffe.ConcatParameter\x12<\n\rsoftmax_param\x18} \x01(\x0b2%.ppq_tpu_torch_caffe.SoftmaxParameter\x12B\n\x10batch_norm_param\x18\x8b\x01 \x01(\x0b2\'.ppq_tpu_torch_caffe.BatchNormParameter\x129\n\x0bscale_param\x18\x8e\x01 \x01(\x0b2#.ppq_tpu_torch_caffe.ScaleParameter\x12=\n\rreshape_param\x18\x85\x01 \x01(\x0b2%.ppq_tpu_torch_caffe.ReshapeParameter\x12=\n\rflatten_param\x18\x87\x01 \x01(\x0b2%.ppq_tpu_torch_caffe.FlattenParameter\x12=\n\rpermute_param\x18\xca\x01 \x01(\x0b2%.ppq_tpu_torch_caffe.PermuteParameter\x12<\n\rdropout_param\x18l \x01(\x0b2%.ppq_tpu_torch_caffe.DropoutParameter\x128\n\x0bpower_param\x18z \x01(\x0b2#.ppq_tpu_torch_caffe.PowerParameter\x12;\n\x0cinterp_param\x18\xcd\x01 \x01(\x0b2$.ppq_tpu_torch_caffe.InterpParameter\x12?\n\x0eupsample_param\x18\xcc\x01 \x01(\x0b2&.ppq_tpu_torch_caffe.UpsampleParameter\x128\n\x0bslice_param\x18~ \x01(\x0b2#.ppq_tpu_torch_caffe.SliceParameter\x129\n\x0binput_param\x18\x8f\x01 \x01(\x0b2#.ppq_tpu_torch_caffe.InputParameter\x12:\n\x0cargmax_param\x18g \x01(\x0b2$.ppq_tpu_torch_caffe.ArgMaxParameter\x129\n\x0bprelu_param\x18\x84\x01 \x01(\x0b2#.ppq_tpu_torch_caffe.PReLUParameter\x129\n\x0brelu6_param\x18\xf3\x01 \x01(\x0b2#.ppq_tpu_torch_caffe.ReLU6Parameter\x12D\n\x11nn_upsample_param\x18\xa3\x01 \x01(\x0b2(.ppq_tpu_torch_caffe.NNUpsampleParameter\x12L\n\x15channel_shuffle_param\x18\xb1\x01 \x01(\x0b2,.ppq_tpu_torch_caffe.ChannelShuffleParameter\x12H\n\x13subpixel_down_param\x18\xd1\x0f \x01(\x0b2*.ppq_tpu_torch_caffe.SubpixelDownParameter\x12D\n\x11subpixel_up_param\x18\xd2\x0f \x01(\x0b2(.ppq_tpu_torch_caffe.SubpixelUpParameter\x127\n\nclip_param\x18\xd3\x0f \x01(\x0b2".ppq_tpu_torch_caffe.ClipParameter\x127\n\ntile_param\x18\xd5\x0f \x01(\x0b2".ppq_tpu_torch_caffe.TileParameter\x125\n\tpad_param\x18\xd6\x0f \x01(\x0b2!.ppq_tpu_torch_caffe.PadParameter\x12;\n\x0creduce_param\x18\xd7\x0f \x01(\x0b2$.ppq_tpu_torch_caffe.ReduceParameter\x12;\n\x0cmatmul_param\x18\x94\' \x01(\x0b2$.ppq_tpu_torch_caffe.MatMulParameter\x12A\n\x0fparameter_param\x18\x95\' \x01(\x0b2\'.ppq_tpu_torch_caffe.ParameterParameter\x12H\n\x13instance_norm_param\x18\x98\' \x01(\x0b2*.ppq_tpu_torch_caffe.InstanceNormParameter\x12?\n\x0equantize_param\x18\xf0. \x03(\x0b2&.ppq_tpu_torch_caffe.QuantizeParameter')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ppq_tpu_torch.frontends.caffe.caffe_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _BLOBSHAPE.fields_by_name['dim']._options = None
  _BLOBSHAPE.fields_by_name['dim']._serialized_options = b'\020\001'
  _BLOBPROTO.fields_by_name['data']._options = None
  _BLOBPROTO.fields_by_name['data']._serialized_options = b'\020\001'
  _BLOBPROTO.fields_by_name['diff']._options = None
  _BLOBPROTO.fields_by_name['diff']._serialized_options = b'\020\001'
  _BLOBSHAPE._serialized_start=50
  _BLOBSHAPE._serialized_end=78
  _BLOBPROTO._serialized_start=81
  _BLOBPROTO._serialized_end=249
  _FILLERPARAMETER._serialized_start=251
  _FILLERPARAMETER._serialized_end=310
  _NETPARAMETER._serialized_start=313
  _NETPARAMETER._serialized_end=480
  _CONVOLUTIONPARAMETER._serialized_start=483
  _CONVOLUTIONPARAMETER._serialized_end=883
  _POOLINGPARAMETER._serialized_start=886
  _POOLINGPARAMETER._serialized_end=1241
  _POOLINGPARAMETER_POOLMETHOD._serialized_start=1195
  _POOLINGPARAMETER_POOLMETHOD._serialized_end=1241
  _INNERPRODUCTPARAMETER._serialized_start=1244
  _INNERPRODUCTPARAMETER._serialized_end=1494
  _RELUPARAMETER._serialized_start=1496
  _RELUPARAMETER._serialized_end=1538
  _ELTWISEPARAMETER._serialized_start=1541
  _ELTWISEPARAMETER._serialized_end=1688
  _ELTWISEPARAMETER_ELTWISEOP._serialized_start=1649
  _ELTWISEPARAMETER_ELTWISEOP._serialized_end=1688
  _CONCATPARAMETER._serialized_start=1690
  _CONCATPARAMETER._serialized_end=1724
  _SOFTMAXPARAMETER._serialized_start=1726
  _SOFTMAXPARAMETER._serialized_end=1761
  _BATCHNORMPARAMETER._serialized_start=1763
  _BATCHNORMPARAMETER._serialized_end=1869
  _SCALEPARAMETER._serialized_start=1871
  _SCALEPARAMETER._serialized_end=1951
  _RESHAPEPARAMETER._serialized_start=1953
  _RESHAPEPARAMETER._serialized_end=2057
  _FLATTENPARAMETER._serialized_start=2059
  _FLATTENPARAMETER._serialized_end=2116
  _PERMUTEPARAMETER._serialized_start=2118
  _PERMUTEPARAMETER._serialized_end=2151
  _DROPOUTPARAMETER._serialized_start=2153
  _DROPOUTPARAMETER._serialized_end=2199
  _POWERPARAMETER._serialized_start=2201
  _POWERPARAMETER._serialized_end=2271
  _INTERPPARAMETER._serialized_start=2273
  _INTERPPARAMETER._serialized_end=2377
  _UPSAMPLEPARAMETER._serialized_start=2379
  _UPSAMPLEPARAMETER._serialized_end=2416
  _SLICEPARAMETER._serialized_start=2418
  _SLICEPARAMETER._serialized_end=2472
  _SIGMOIDPARAMETER._serialized_start=2474
  _SIGMOIDPARAMETER._serialized_end=2492
  _TANHPARAMETER._serialized_start=2494
  _TANHPARAMETER._serialized_end=2509
  _ABSVALPARAMETER._serialized_start=2511
  _ABSVALPARAMETER._serialized_end=2528
  _INPUTPARAMETER._serialized_start=2530
  _INPUTPARAMETER._serialized_end=2593
  _QUANTIZEPARAMETER._serialized_start=2596
  _QUANTIZEPARAMETER._serialized_end=2756
  _PRELUPARAMETER._serialized_start=2758
  _PRELUPARAMETER._serialized_end=2859
  _ARGMAXPARAMETER._serialized_start=2861
  _ARGMAXPARAMETER._serialized_end=2938
  _TILEPARAMETER._serialized_start=2940
  _TILEPARAMETER._serialized_end=2990
  _CHANNELSHUFFLEPARAMETER._serialized_start=2992
  _CHANNELSHUFFLEPARAMETER._serialized_end=3035
  _CLIPPARAMETER._serialized_start=3037
  _CLIPPARAMETER._serialized_end=3078
  _REDUCEPARAMETER._serialized_start=3080
  _REDUCEPARAMETER._serialized_end=3131
  _INSTANCENORMPARAMETER._serialized_start=3133
  _INSTANCENORMPARAMETER._serialized_end=3221
  _MATMULPARAMETER._serialized_start=3223
  _MATMULPARAMETER._serialized_end=3257
  _SUBPIXELDOWNPARAMETER._serialized_start=3259
  _SUBPIXELDOWNPARAMETER._serialized_end=3305
  _SUBPIXELUPPARAMETER._serialized_start=3307
  _SUBPIXELUPPARAMETER._serialized_end=3349
  _NNUPSAMPLEPARAMETER._serialized_start=3351
  _NNUPSAMPLEPARAMETER._serialized_end=3391
  _PADPARAMETER._serialized_start=3393
  _PADPARAMETER._serialized_end=3476
  _RELU6PARAMETER._serialized_start=3478
  _RELU6PARAMETER._serialized_end=3521
  _PARAMETERPARAMETER._serialized_start=3524
  _PARAMETERPARAMETER._serialized_end=3652
  _LAYERPARAMETER._serialized_start=3655
  _LAYERPARAMETER._serialized_end=5866
# @@protoc_insertion_point(module_scope)
