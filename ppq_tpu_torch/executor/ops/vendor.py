"""Per-platform op-table overrides (port of ppq_tpu/executor/ops/vendor.py;
reference executor/op/torch/{nxp,dsp,cuda,academic,onnx}.py). The
reference keeps full table copies per platform; here platform tables hold
only the DIFFS against the default table (resolve_forward falls back
automatically) — the only behavioral override the reference actually ships
is NXP's Resize."""

from __future__ import annotations

from ...core import TargetPlatform
from .default import Resize_forward


def NXP_Resize_forward(op, values, ctx=None):
    """NXP hardware resizes with NEAREST interpolation regardless of the
    onnx mode attribute (reference op/torch/nxp.py:9-51 Resize_forward) —
    forcing nearest here keeps simulation == NXP silicon."""
    forced = dict(op.attributes)
    forced['mode'] = 'nearest'
    tm = forced.get('coordinate_transformation_mode', 'half_pixel')
    if tm != 'align_corners':
        forced['coordinate_transformation_mode'] = 'asymmetric'

    class _Shim:
        type = op.type
        name = op.name
        attributes = forced
        inputs = op.inputs
        outputs = op.outputs
    return Resize_forward(_Shim(), values, ctx)


def register_vendor_tables():
    from ..base import register_operation_handler
    for plat in (TargetPlatform.NXP_INT8, TargetPlatform.FPGA_INT8,
                 TargetPlatform.TPU_POWER_OF_2):
        register_operation_handler(NXP_Resize_forward, 'Resize', plat)


register_vendor_tables()
