"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.

| TPU kernel (ppq_tpu/kernels)                  | here                       |
|-----------------------------------------------|----------------------------|
| quant.pallas_linear_quant, tensorwise         | quant.linear_quant         |
| quant.pallas_linear_quant, channelwise        | quant.linear_quant         |
| histogram.pallas_histogram                    | histogram.histogram        |
| quant.pallas_linear_quant_bwd, tensorwise     | quant.linear_quant_bwd     |
| quant.pallas_linear_quant_bwd, channelwise    | quant.linear_quant_bwd     |
| floating.pallas_floating_quant (both bodies)  | floating.floating_quant    |
| floating.pallas_floating_quant_bwd            | floating.floating_quant_bwd|
| qmm.qmm_int8                                  | qmm.qmm_int8               |
| qmm.qmm_int4                                  | qmm.qmm_int4               |
| qmm.qmm_gateup (INT8 and INT4 bodies)         | qmm.qmm_gateup             |
| paged_attention.paged_attention_decode_fused  | paged_attention.paged_attention_decode_fused |
| paged_attention.paged_attention_decode_grouped | paged_attention.paged_attention_decode_grouped |
| paged_attention.paged_attention_decode_buffered | paged_attention.paged_attention_decode_buffered |
| bank_write.bank_write_inplace                 | bank_write.bank_write_inplace |
| window_write.window_write_inplace             | window_write.window_write_inplace |
| pool_write.pool_write                         | pool_write.pool_write_inplace |

The kernels are built by `loader.build()` at first use; a wrapper given a
CPU tensor runs the plain version, a CUDA tensor launches the kernel or
raises. Inputs that only the card can check (a device-side column, fill or
table row out of range) set a bit of the device's fault word, which
`read_faults` reads.
"""

from .loader import LAUNCHES, build, read_faults, reset_launches
from .histogram import histogram, histogram_plain
from .quant import (linear_quant, linear_quant_bwd, linear_quant_bwd_plain,
                    linear_quant_plain)
from .floating import (floating_quant, floating_quant_bwd,
                       floating_quant_bwd_plain, floating_quant_plain)
from .qmm import (pack_int4_splithalf, qmm_gateup, qmm_gateup_plain,
                  qmm_int4, qmm_int4_plain, qmm_int8, qmm_int8_plain,
                  unpack_int4_splithalf)
from .paged_attention import (blockmajor_window, grouped_group_size,
                              identity_block_tables, merge_attention,
                              paged_attention_decode_buffered,
                              paged_attention_decode_buffered_plain,
                              paged_attention_decode_fused,
                              paged_attention_decode_fused_plain,
                              paged_attention_decode_grouped,
                              paged_attention_decode_grouped_plain,
                              paged_attention_reference, slotmajor_window)
from .bank_write import (Bank, bank_write_inplace, bank_write_plain,
                         supports_bank)
from .window_write import (supports_dense, window_write_inplace,
                           window_write_plain)
from .pool_write import pool_write_inplace, pool_write_plain

__all__ = ['LAUNCHES', 'build', 'read_faults', 'reset_launches', 'histogram',
           'histogram_plain', 'linear_quant', 'linear_quant_plain',
           'linear_quant_bwd', 'linear_quant_bwd_plain', 'floating_quant',
           'floating_quant_plain', 'floating_quant_bwd',
           'floating_quant_bwd_plain', 'qmm_int8', 'qmm_int8_plain',
           'qmm_gateup', 'qmm_gateup_plain', 'qmm_int4', 'qmm_int4_plain',
           'pack_int4_splithalf', 'unpack_int4_splithalf',
           'paged_attention_decode_fused',
           'paged_attention_decode_fused_plain',
           'paged_attention_decode_grouped',
           'paged_attention_decode_grouped_plain',
           'paged_attention_decode_buffered',
           'paged_attention_decode_buffered_plain',
           'paged_attention_reference', 'blockmajor_window',
           'slotmajor_window', 'identity_block_tables', 'grouped_group_size',
           'merge_attention', 'bank_write_inplace',
           'bank_write_plain', 'supports_bank', 'Bank', 'window_write_inplace',
           'window_write_plain', 'supports_dense', 'pool_write_inplace',
           'pool_write_plain']
