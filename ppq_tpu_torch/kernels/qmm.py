"""Fused dequant-matmul for weight-only INT8 and INT4 serving: the CUDA
kernels' wrappers and their plain versions.

Counterpart of ppq_tpu/kernels/qmm.py `qmm_int8` (`_qmm8_kernel`,
`_mk_qmm8_ex`), `qmm_int4` (`_mk_qmm4_ex`) and `qmm_gateup` (both bodies,
`_qmm8_gu_kernel` and `_qmm4_gu_kernel`). The kernels are
`ppq_tpu_torch/csrc/qmm.cu`; its source says what bounds them on the card
and how the design meets that.

    qmm_int8:   out = (x_bf16 @ w_int8, f32 sum) * scale[F]
                      [* row_scale[B]] [+ residual[B, F]]
    qmm_int4:   the same with w split-half packed (D/2, F): byte row r holds
                w[r] in its low nibble and w[r + D/2] in its high nibble
    qmm_gateup: g = (x @ Wg) * sg [* row]; u = (x @ Wu) * su [* row]
                out = g * sigmoid(g) * u,  weight = [Wg | Wu]  (D, 2 F) int8
                or (D/2, 2 F) packed (the INT4 body: rows * 2 == D)

The epilogue runs in f32 in that order and the result is cast once.

Every body launches once a call: a 128-row tile of 128 weight columns,
64-deep steps through a `cp.async` ring (an INT4 step reads 32 packed rows,
64 of the unpacked depth), the depth split across S blocks a tile
(`_splits`, from the weight's shape and the body alone), the f32 partials
summed in a fixed order inside the launch, in a workspace each (device,
stream) keeps (a launch inside a CUDA-graph capture: its device's graph
workspace, `reserve_graph_workspace`). The INT8 bodies multiply with
`mma.sync`, the INT4 bodies with `wgmma`. Two calls on the same inputs
are bit-equal, and a row's result does not depend on the other rows of
its batch. What bounds them at the decode shapes is the time of a step,
not bytes or operations (csrc/qmm.cu, PERF.md).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .loader import LAUNCHES, check, library, stream_of

# SMs of an H100: below this many column tiles the bodies split the depth
_SMS = 132
# the kernels' tile: rows of x a block, depth a step
_BM, _BK = 128, 64
# split-K: each split at least this many steps; the cost model's terms for
# each body (int4: False, True), in us: a 64-deep step of a 128 x 128 tile,
# one partial tile written and summed by a tile's last block, and what a
# wave of blocks costs beside its steps. Fitted to `chip_smoke.py --qmm`'s
# sweep on an H100 (PERF.md): the INT8 bodies on mma.sync (no wave term),
# the INT4 bodies on wgmma, whose cheaper step leaves each block's fixed
# cost (the ring's first loads, the epilogue) to decide a second wave
_MIN_SPLIT_STEPS = 4
_COST_US = {False: (1.24, 1.78, 0.0), True: (0.82, 1.47, 6.5)}
# depth of the kernels' cp.async rings (csrc/qmm.cu STAGES, STAGES4)
_STAGES, _STAGES4 = 4, 5


def supports(d: int, f: int, b: int = 64) -> bool:
    """The shapes the kernel tiles: the JAX package's rule without its
    fast-memory budget, which has no counterpart on the card."""
    return d % 256 == 0 and f % 128 == 0 and b >= 1


def supports_int4(dp: int, f: int, b: int = 64) -> bool:
    """dp = packed contraction depth (D // 2). The JAX package's rule
    without its fast-memory budget (which also refuses shapes whose unpacked
    panel would not fit 16 MiB of TPU memory; nothing here corresponds)."""
    return dp % 256 == 0 and f % 128 == 0 and b >= 1


def tiles_int8(d: int, f: int, b: int = 64) -> bool:
    """The shapes the INT8 body runs: the depth in whole 64-deep steps, the
    columns in whole 128-column tiles. `supports` routes a weight as the
    JAX package does; a row-parallel shard of a weight it routes here
    (serving/tensor_parallel.py, a fraction of the depth) needs only this."""
    return d % _BK == 0 and f % 128 == 0 and b >= 1


def tiles_int4(dp: int, f: int, b: int = 64) -> bool:
    """`tiles_int8` for the INT4 body, dp the packed depth (a step reads 32
    packed rows)."""
    return dp % (_BK // 2) == 0 and f % 128 == 0 and b >= 1


def supports_gateup(d: int, f2: int, b: int, bits: int = 8) -> bool:
    """f2 = fused gate|up output width (2 * d_ff); bits 8 or 4."""
    if f2 % 2 or bits not in (8, 4):
        return False
    f = f2 // 2
    if bits == 8:
        return d % 256 == 0 and f % 128 == 0 and b >= 1
    return d % 2 == 0 and (d // 2) % 256 == 0 and f % 128 == 0 and b >= 1


# ------------------------------------------------------- int4 packing ----

def pack_int4_splithalf(q):
    """(D, F) int8 in [-8, 7] -> (D//2, F) packed: row r =
    (q[r] & 0xF) | (q[r + D//2] << 4). numpy in, numpy out; a tensor in, a
    tensor out on its device."""
    D = q.shape[0]
    if D % 2:
        raise ValueError(f'split-half packing needs an even depth, got {D}')
    if isinstance(q, np.ndarray):
        lo = q[: D // 2] & 0x0F
        hi = (q[D // 2:] & 0x0F) << 4
        return (lo | hi).astype(np.int8)
    q32 = q.to(torch.int32)
    packed = (q32[: D // 2] & 0x0F) | ((q32[D // 2:] & 0x0F) << 4)
    # 0..255 -> the int8 with the same bits
    return torch.where(packed > 127, packed - 256, packed).to(torch.int8)


def unpack_int4_splithalf(packed):
    """Inverse of pack_int4_splithalf: (D//2, F) -> (D, F) int8 in [-8, 7].
    The low nibble sign-extends as ((p & 15) ^ 8) - 8, the high nibble is an
    arithmetic shift of the signed byte."""
    if isinstance(packed, np.ndarray):
        p32 = packed.astype(np.int32)
        return np.concatenate([((p32 & 15) ^ 8) - 8, p32 >> 4],
                              axis=0).astype(np.int8)
    p32 = packed.to(torch.int32)
    return torch.cat([((p32 & 15) ^ 8) - 8, p32 >> 4], dim=0).to(torch.int8)


def _row(row_scale, rows):
    return None if row_scale is None \
        else row_scale.reshape(rows, 1).to(torch.float32)


def qmm_int8_plain(x, w_int, scale, out_dtype=torch.bfloat16,
                   row_scale=None, residual=None):
    """The kernel's arithmetic in plain PyTorch, on any device: operands
    rounded to bf16, an f32 product, then scale, row scale and residual one
    by one in f32."""
    B = x.shape[0]
    acc = torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                       w_int.to(torch.float32))
    acc = acc * scale.to(torch.float32).reshape(1, -1)
    if row_scale is not None:
        acc = acc * _row(row_scale, B)
    if residual is not None:
        acc = acc + residual.reshape(B, -1).to(torch.float32)
    return acc.to(out_dtype)


def qmm_int4_plain(x, w_packed, scale, out_dtype=torch.bfloat16,
                   row_scale=None, residual=None):
    """The INT4 kernel's arithmetic: the nibbles unpacked (exact), then the
    INT8 kernel's."""
    return qmm_int8_plain(x, unpack_int4_splithalf(w_packed), scale,
                          out_dtype, row_scale, residual)


def qmm_gateup_plain(x, w_int, scale, out_dtype=torch.bfloat16,
                     row_scale=None):
    """Both bodies: a packed weight (rows * 2 == D) is unpacked first."""
    if w_int.shape[0] * 2 == x.shape[1]:
        w_int = unpack_int4_splithalf(w_int)
    B = x.shape[0]
    F = w_int.shape[1] // 2
    both = torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                        w_int.to(torch.float32))
    both = both * scale.to(torch.float32).reshape(1, -1)
    if row_scale is not None:
        both = both * _row(row_scale, B)
    g, u = both[:, :F], both[:, F:]
    return (g * torch.sigmoid(g) * u).to(out_dtype)


def _check(x, w_int, scale, out_dtype, what, depth=1):
    """depth: unpacked rows per weight row (2 for a packed INT4 weight)."""
    if x.dim() != 2 or w_int.dim() != 2 \
            or x.shape[1] != depth * w_int.shape[0]:
        raise ValueError(f'{what}: x {tuple(x.shape)} against w '
                         f'{tuple(w_int.shape)}')
    if w_int.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f'{what} takes an int8 weight and float32 scales')
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'{what} writes float32 or bfloat16, not {out_dtype}')
    if scale.numel() != w_int.shape[1]:
        raise ValueError(f'{what}: {scale.numel()} scales for '
                         f'{w_int.shape[1]} columns')
    for t in (w_int, scale):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f'{what} takes contiguous tensors on {x.device}')


def _aligned(what, *tensors):
    """The kernels read x in 16-byte vectors and the other operands in
    pairs: a view at an odd storage offset would fault on the card."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f'{what} takes 16-byte aligned tensors')


def _bn(gateup: bool) -> int:
    """Output columns of a tile, 128 weight columns a step: one panel of
    128, or gate-up's two of 64."""
    return 64 if gateup else 128


def _splits(D: int, F: int, gateup: bool = False, int4: bool = False) -> int:
    """S, the blocks that share each output tile's depth, from the
    weight's shape and the body alone: D is the unpacked depth (an INT4
    step is 64 deep as an INT8 one), F the output width (gate-up: one
    panel's). 1 where the column tiles alone give every SM a block. Else
    the S, each split at least _MIN_SPLIT_STEPS steps deep, that the body's
    cost model says is quickest for one row tile (M <= 128, every decode
    step): the waves of one block an SM times the steps of a split and the
    wave's own cost, plus the partial tiles the last block sums; then
    evened out so that no split is empty. S does not depend on the rows,
    so a row's sum is taken in the same order whatever batch it comes in,
    as before the split."""
    tiles, steps = F // _bn(gateup), D // _BK
    if tiles >= _SMS:
        return 1
    step_us, partial_us, wave_us = _COST_US[int4]

    def evened(s):
        return -(-steps // -(-steps // s))

    def cost(s):
        waves = -(-tiles * s // _SMS)
        return waves * (-(-steps // s) * step_us + wave_us) \
            + (s > 1) * s * partial_us

    shapes = {evened(s) for s in range(1, steps // _MIN_SPLIT_STEPS + 1)}
    return min(shapes | {1}, key=lambda s: (cost(s), s))


def qmm_launch(M: int, D: int, F: int, gateup: bool = False,
               int4: bool = False) -> dict:
    """How a body launches at this shape (D unpacked): its grid (column
    tiles, row tiles, S), the tile's columns (gate-up: each panel's), the
    loads and the product."""
    return dict(grid=[F // _bn(gateup), -(-M // _BM),
                      _splits(D, F, gateup, int4)],
                BN=_bn(gateup),
                loads=f'{_STAGES4 if int4 else _STAGES}-stage cp.async ring',
                product='wgmma m64n128k16' if int4 else 'mma.sync m16n8k16')


def split_ranges(D: int, F: int, gateup: bool = False, int4: bool = False):
    """The range [k0, k1) of the depth each split of a launch sums, as the
    kernel cuts it: S ranges of ceil(steps / S) 64-deep steps, the last
    shorter. An INT4 split takes packed rows [k0 / 2, k1 / 2), which
    multiply x[:, k0 / 2 : k1 / 2] and x[:, D/2 + k0 / 2 : D/2 + k1 / 2]."""
    S, steps = _splits(D, F, gateup, int4), D // _BK
    per = -(-steps // S)
    return [(s * per * _BK, min(steps, (s + 1) * per) * _BK)
            for s in range(S)]


def workspace_bytes(M: int, D: int, F: int, gateup: bool = False,
                    int4: bool = False) -> int:
    """Bytes of the f32 partial sums a launch writes, INT8 or INT4 (D
    unpacked): S planes of the (M, F) product, both panels for gate-up;
    none when S is 1."""
    S = _splits(D, F, gateup, int4)
    return 0 if S == 1 else S * M * F * 4 * (2 if gateup else 1)


# (device, stream) -> (partial sums, tile counters): allocated at the first
# split launch on that stream, INT8 or INT4, grown when a larger shape
# arrives, never shrunk. Launches on one stream run one after another, and
# each leaves its counters at 0 for the next. A launch inside a CUDA-graph
# capture takes instead its device's graph pair (`reserve_graph_workspace`),
# reserved before the first capture at the largest shape any graph of the
# device replays: every graph reads and writes that one pair, and graphs
# replay one at a time on one stream. A capture never grows it, and a pair
# that a later reserve replaces stays allocated (a graph holds its address).
_workspaces: Dict[Tuple[torch.device, int], Tuple[torch.Tensor,
                                                  torch.Tensor]] = {}
_graph_workspaces: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
_retired_graph_workspaces: List[Tuple[torch.Tensor, torch.Tensor]] = []


def _device_key(device) -> torch.device:
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    return device


def launch_workspace(M: int, D: int, F: int, gateup: bool = False,
                     int4: bool = False) -> Tuple[int, int]:
    """(floats of partial sums, tile counters) of one launch, D unpacked and
    F a panel's columns; (0, 0) when the depth is not split."""
    if _splits(D, F, gateup, int4) == 1:
        return 0, 0
    return (workspace_bytes(M, D, F, gateup, int4) // 4,
            -(-M // _BM) * (F // _bn(gateup)))


def reserve_graph_workspace(device, launches) -> Tuple[int, int]:
    """Make `device`'s graph pair cover every launch of `launches`, an
    iterable of (M, D, F, gateup, int4) as `launch_workspace` takes them.
    Call it outside a capture, before the graphs that replay those
    launches are captured. Returns the pair's (floats, counters)."""
    device = _device_key(device)
    floats = tiles = 0
    for launch in launches:
        f, t = launch_workspace(*launch)
        floats, tiles = max(floats, f), max(tiles, t)
    ws, counters = _graph_workspaces.get(device, (None, None))
    if ws is not None and ws.numel() >= floats and counters.numel() >= tiles:
        return ws.numel(), counters.numel()
    if ws is not None:
        _retired_graph_workspaces.append((ws, counters))
        floats, tiles = max(floats, ws.numel()), max(tiles, counters.numel())
    ws = torch.empty(max(floats, 1), dtype=torch.float32, device=device)
    counters = torch.zeros(max(tiles, 1), dtype=torch.int32, device=device)
    _graph_workspaces[device] = (ws, counters)
    return ws.numel(), counters.numel()


def _workspace(device: torch.device, stream: int, floats: int, tiles: int):
    key = (device, stream)
    ws, counters = _workspaces.get(key, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(tiles, dtype=torch.int32, device=device)
    _workspaces[key] = (ws, counters)
    return ws, counters


def _split_args(x, M, D, F, gateup, int4):
    """(S, workspace pointer, counters pointer) of a launch; D unpacked."""
    S = _splits(D, F, gateup, int4)
    if S == 1:
        return 1, None, None
    floats, tiles = launch_workspace(M, D, F, gateup, int4)
    if torch.cuda.is_current_stream_capturing():
        ws, counters = _graph_workspaces.get(_device_key(x.device),
                                             (None, None))
        if ws is None or ws.numel() < floats or counters.numel() < tiles:
            raise RuntimeError(
                f'qmm: a captured launch of {M}x{D}x{F} needs {floats} '
                f'partial floats and {tiles} counters in the graph '
                f'workspace: reserve_graph_workspace before the capture')
    else:
        ws, counters = _workspace(
            x.device, torch.cuda.current_stream(x.device).cuda_stream,
            floats, tiles)
    return S, ws.data_ptr(), counters.data_ptr()


def _launch_qmm(entry, what, x, w, scale, out_dtype, row_scale, residual):
    """The INT8 and INT4 kernels' launch: x (B, D) bf16, w (D or D/2, F)."""
    B, D = x.shape
    F = w.shape[1]
    x = x.to(torch.bfloat16).contiguous()
    row = None
    if row_scale is not None:
        row = _row(row_scale, B).contiguous()
    res = None
    if residual is not None:
        res = residual.reshape(B, F)
        if res.dtype not in (torch.float32, torch.bfloat16):
            res = res.to(torch.float32)
        res = res.contiguous()
    out = torch.empty((B, F), dtype=out_dtype, device=x.device)
    _aligned(what, x, w, scale, row, res, out)
    lib = library('qmm')
    split = _split_args(x, B, D, F, False, what == 'qmm_int4')
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(),
            None if row is None else row.data_ptr(),
            None if res is None else res.data_ptr(),
            int(res is not None and res.dtype == torch.float32),
            out.data_ptr(), int(out_dtype == torch.float32), B, D, F,
            *split, stream_of(x.device))
    check(rc, what)
    LAUNCHES[what] += 1
    return out


def qmm_int8(x: torch.Tensor, w_int: torch.Tensor, scale: torch.Tensor,
             out_dtype=torch.bfloat16,
             row_scale: Optional[torch.Tensor] = None,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, D); w_int: (D, F) int8; scale: (F,) f32 -> (B, F).
    row_scale: optional (B,) or (B, 1) f32 multiplied into each output row;
    residual: optional (B, F), bf16 or f32, added after all scaling.
    CPU tensors take the plain version; CUDA tensors the kernel."""
    _check(x, w_int, scale, out_dtype, 'qmm_int8')
    if x.device.type == 'cpu':
        return qmm_int8_plain(x, w_int, scale, out_dtype, row_scale, residual)
    if x.device.type != 'cuda':
        raise ValueError(f'qmm_int8 runs on cpu or cuda, not {x.device}')
    B, D = x.shape
    F = w_int.shape[1]
    if not tiles_int8(D, F, B):
        raise ValueError(f'qmm_int8 does not tile D={D}, F={F}')
    return _launch_qmm('ppq_qmm_int8', 'qmm_int8', x, w_int, scale,
                       out_dtype, row_scale, residual)


def qmm_int4(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor,
             out_dtype=torch.bfloat16,
             row_scale: Optional[torch.Tensor] = None,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, D); w_packed: (D//2, F) split-half int4; scale: (F,) f32 ->
    (B, F), with qmm_int8's epilogue in its order. The low nibbles multiply
    x[:, :D/2], the high nibbles x[:, D/2:]. CPU tensors take the plain
    version; CUDA tensors the kernel."""
    _check(x, w_packed, scale, out_dtype, 'qmm_int4', depth=2)
    if x.device.type == 'cpu':
        return qmm_int4_plain(x, w_packed, scale, out_dtype, row_scale,
                              residual)
    if x.device.type != 'cuda':
        raise ValueError(f'qmm_int4 runs on cpu or cuda, not {x.device}')
    B, D = x.shape
    F = w_packed.shape[1]
    if not tiles_int4(D // 2, F, B):
        raise ValueError(f'qmm_int4 does not tile D={D}, F={F}')
    return _launch_qmm('ppq_qmm_int4', 'qmm_int4', x, w_packed, scale,
                       out_dtype, row_scale, residual)


def qmm_gateup(x: torch.Tensor, w_int: torch.Tensor, scale: torch.Tensor,
               out_dtype=torch.bfloat16,
               row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused SwiGLU front half: silu(x @ Wg) * (x @ Wu), the weight being
    the [gate | up] concatenation, (D, 2 F) int8 or (D/2, 2 F) split-half
    INT4 (chosen as the JAX package chooses: rows * 2 == D). The (B, 2 F)
    projection never reaches device memory. CPU tensors take the plain
    version; CUDA tensors the kernel. The INT4 body counts its launches as
    `qmm_gateup_int4`."""
    int4 = x.dim() == 2 and w_int.dim() == 2 \
        and w_int.shape[0] * 2 == x.shape[1]
    _check(x, w_int, scale, out_dtype, 'qmm_gateup', depth=2 if int4 else 1)
    B, D = x.shape
    if x.device.type == 'cpu':
        return qmm_gateup_plain(x, w_int, scale, out_dtype, row_scale)
    if x.device.type != 'cuda':
        raise ValueError(f'qmm_gateup runs on cpu or cuda, not {x.device}')
    F2 = w_int.shape[1]
    if not supports_gateup(D, F2, B, 4 if int4 else 8):
        raise ValueError(f'qmm_gateup does not tile D={D}, 2F={F2}')
    F = F2 // 2
    x = x.to(torch.bfloat16).contiguous()
    row = None if row_scale is None else _row(row_scale, B).contiguous()
    out = torch.empty((B, F), dtype=out_dtype, device=x.device)
    _aligned('qmm_gateup', x, w_int, scale, row, out)
    lib = library('qmm')
    entry = lib.ppq_qmm_gateup_int4 if int4 else lib.ppq_qmm_gateup
    split = _split_args(x, B, D, F, True, int4)
    with torch.cuda.device(x.device):
        rc = entry(x.data_ptr(), w_int.data_ptr(), scale.data_ptr(),
                   None if row is None else row.data_ptr(), out.data_ptr(),
                   int(out_dtype == torch.float32), B, D, F, *split,
                   stream_of(x.device))
    name = 'qmm_gateup_int4' if int4 else 'qmm_gateup'
    check(rc, name)
    LAUNCHES[name] += 1
    return out
