"""Paged decode attention: the CUDA kernel's launcher, its plain
PyTorch version, and the host helpers around it.

Port of ``repro.kernels.paged_attention``.  The TPU kernel it replaces
(``paged_attention`` / ``_paged_attn_kernel``) becomes
``csrc/paged_attention.cu`` for sm_90a — see that file for the design
and what bounds it.  :func:`paged_plan` cuts a call into splits of a
row's pages from shapes alone; :func:`paged_attention_cuda` checks and
launches the split kernel and its combine pass;
:func:`paged_attention_plain` is the same function in plain PyTorch.
Callers go through ``repro_torch.kernels.ops``, which picks one of the
two by the tensors' device.

:func:`decode_prefetch` packs a decode step's block tables and lengths
into the one ``(B, M+1)`` int32 operand the kernel reads (built once
per step, shared by every layer); :func:`decode_hbm_bytes` is the TPU
kernel's analytic K/V byte count of one call, page-granular.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_HEAD_DIM = 512           # csrc kWideHd (rows past 256: the wide form)
MAX_GROUP_OUT = 2048         # csrc kThreads * kMaxOutPerThread: a block's
                             # (query head, feature) outputs
SPLIT_BYTES = 64 * 1024      # K/V bytes a split reads at most
TILE_BYTES = 16 * 1024       # bytes of one staged tile
STAGES = 2                   # csrc kStages: tiles in the cp.async ring
BLOCKS_PER_SM = 4            # splits are cut shorter below this
MAX_SPLITS = 65_535          # splits run along grid.z


def decode_prefetch(block_tables, lengths) -> torch.Tensor:
    """Pack a decode step's block tables (B, M) and per-row lengths (B,)
    into ONE (B, M+1) int32 operand: columns 0..M-1 are page ids, column
    M is the row's length.  Pass it as ``paged_attention(...,
    prefetch=...)``."""
    bt = torch.as_tensor(block_tables).to(torch.int32)
    ln = torch.as_tensor(lengths, device=bt.device).to(torch.int32)
    return torch.cat([bt, ln.reshape(bt.shape[0], 1)], dim=1).contiguous()


def decode_hbm_bytes(k_pages, v_pages, block_tables, lengths, *,
                     window: Optional[int] = None,
                     chunk: Optional[int] = None,
                     v_dim: Optional[int] = None) -> int:
    """Analytic K/V device-memory bytes of one call of the TPU kernel:
    a host-side mirror of its per-page liveness test (length / window /
    chunk), counting whole live pages (and their int8 scale slabs) once
    per (row, kv_head).  The CUDA kernel reads only the visible tokens
    of each live page, so this is an upper bound on its K/V traffic.
    """
    ps = int(k_pages.shape[1])
    kk = int(k_pages.shape[2])
    hd = int(k_pages.shape[3])
    vd = int(v_dim) if v_dim is not None else int(v_pages.shape[-1])
    visit = (ps * hd * k_pages.dtype.itemsize
             + ps * vd * v_pages.dtype.itemsize)
    if k_pages.dtype == torch.int8:     # two bf16 (slot, head) scale rows
        visit += 2 * ps * 2
    m = int(block_tables.shape[1])
    live_pages = 0
    for length in torch.as_tensor(lengths).reshape(-1).tolist():
        q_pos = length - 1
        for i in range(m):
            k_first, k_last = i * ps, i * ps + ps - 1
            live = k_first < length
            if window is not None:
                live &= k_last > q_pos - window
            if chunk is not None:
                live &= k_last >= (q_pos // chunk) * chunk
            live_pages += bool(live)
    return live_pages * kk * visit


def paged_attention_plain(q, k_pages, v_pages, block_tables, lengths, *,
                          window: Optional[int] = None,
                          chunk: Optional[int] = None,
                          logit_cap: Optional[float] = None,
                          scale: Optional[float] = None,
                          k_scales=None, v_scales=None,
                          v_dim: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: int8 pages dequantise in
    fp32 (as the kernel, and the TPU kernel, do), ``v_dim`` slices the
    leading V features, then the gather oracle
    ``ref.paged_attention_ref``."""
    if k_pages.dtype == torch.int8:
        k_pages = k_pages.float() * k_scales.float()[..., None]
        v_pages = v_pages.float() * v_scales.float()[..., None]
    if v_dim is not None:
        v_pages = v_pages[..., :v_dim]
    return ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   lengths, window=window, chunk=chunk,
                                   scale=scale, logit_cap=logit_cap)


_lib = None


def _launcher():
    global _lib
    if _lib is None:
        lib = build.load("paged_attention")
        fn = lib.paged_attention_launch
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([ci, ci] + [vp] * 6 + [ci, vp, ci, vp, vp, vp]
                       + [ci] * 14 + [cf, cf, ci, ci, vp])
        fn.restype = ci
        _lib = fn
    return _lib


def _refuse(msg: str):
    raise ValueError(f"paged_attention kernel: {msg}")


class PagedPlan(NamedTuple):
    """How a launch cuts the work: each (row, KV head) walks its block
    table in ``num_splits`` runs of ``pages_per_split`` pages, one block
    each, staging ``tile`` tokens at a time; ``smem_bytes`` is a split
    block's dynamic shared memory.  With more than one split a combine
    pass merges the partials.  Where a KV head's group of query heads
    has more (head, feature) outputs than a block owns
    (``MAX_GROUP_OUT``: absorbed MLA, 40 heads x v_dim 256), its heads
    are cut into ``head_tiles`` tiles of :func:`tile_heads` heads, one
    block each, which read the same K/V rows; every other shape has one
    tile."""
    pages_per_split: int
    num_splits: int
    tile: int
    smem_bytes: int
    head_tiles: int = 1


def head_tiling(group: int, v_dim: int) -> int:
    """Head tiles of a KV head's ``group`` query heads: the fewest whose
    heads' ``v_dim`` outputs each fit ``MAX_GROUP_OUT`` (1 where the
    whole group fits)."""
    per_block = max(1, MAX_GROUP_OUT // v_dim)
    return -(-group // per_block)


def tile_heads(group: int, head_tiles: int) -> int:
    """Query heads a block owns (the last tile may own fewer)."""
    return -(-group // head_tiles)


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def split_smem_bytes(itemsize: int, group: int, head_dim: int, v_dim: int,
                     page_size: int, pages_per_split: int, tile: int,
                     quantized: bool) -> int:
    """Dynamic shared memory of a split block, the layout that
    ``csrc/paged_attention.cu``'s split kernel carves (the launch asks
    for this count): the tile ring, q, the split's scores, int8 scales,
    m / l and page ids."""
    kb, vb = _round16(head_dim * itemsize), _round16(v_dim * itemsize)
    split_tokens = pages_per_split * page_size
    return (STAGES * tile * max(kb, vb)
            + 4 * (group * (kb // itemsize) + group * split_tokens
                   + (2 * split_tokens if quantized else 0) + 2 * group)
            + 4 * pages_per_split)


@functools.lru_cache(maxsize=256)
def paged_plan(batch: int, kv_heads: int, group: int, max_pages: int,
               page_size: int, head_dim: int, v_dim: int, itemsize: int,
               quantized: bool, sms: int, smem_limit: int) -> PagedPlan:
    """The split plan of a call, from shapes alone (never the lengths,
    so a decode step reads nothing back from the card): a split reads
    at most ``SPLIT_BYTES`` of K/V for one (row, KV head), and is cut
    shorter where fewer than ``BLOCKS_PER_SM`` blocks on each of the
    ``sms`` SMs would exist (a head tile is a block of its own);
    a tile stages about ``TILE_BYTES``.  Both shrink until a block's
    shared memory fits in ``smem_limit`` bytes.  Cached per shape."""
    tiles = head_tiling(group, v_dim)
    heads = tile_heads(group, tiles)
    per_token = (head_dim + v_dim) * itemsize + (4 if quantized else 0)
    pps = max(1, SPLIT_BYTES // (page_size * per_token))
    fill = max_pages * batch * kv_heads * tiles // (BLOCKS_PER_SM * sms)
    pps = max(1, min(pps, fill, max_pages), -(-max_pages // MAX_SPLITS))
    row = max(_round16(head_dim * itemsize), _round16(v_dim * itemsize))
    tile = max(1, min(TILE_BYTES // row, pps * page_size))
    while True:
        smem = split_smem_bytes(itemsize, heads, head_dim, v_dim, page_size,
                                pps, tile, quantized)
        if smem <= smem_limit or (tile == 1 and pps == 1):
            break
        if tile > 1:
            tile //= 2
        else:
            pps = (pps + 1) // 2
    if smem > smem_limit:
        _refuse(f"{smem} bytes of shared memory > {smem_limit} (group "
                f"{group}, head_dim {head_dim}, page {page_size})")
    return PagedPlan(pps, max(1, -(-max_pages // pps)), tile, smem, tiles)


def scratch_floats(plan: PagedPlan, batch: int, kv_heads: int, group: int,
                   v_dim: int) -> int:
    """fp32 partials of a launch: (m, l) and acc[v_dim] for every
    (row, KV head, split, query head); none with one split."""
    if plan.num_splits == 1:
        return 0
    return batch * kv_heads * plan.num_splits * group * (v_dim + 2)


@functools.lru_cache(maxsize=16)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=16)
def smem_optin(device_index: int) -> int:
    """Shared memory a block may opt into on a CUDA device (cached)."""
    fn = build.load("paged_attention").paged_attention_smem_optin
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    rc = fn(device_index, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"paged_attention: shared memory query failed: "
                           f"CUDA error {rc}")
    return out.value


def paged_attention_cuda(q, k_pages, v_pages, block_tables, lengths, *,
                         window: Optional[int] = None,
                         chunk: Optional[int] = None,
                         logit_cap: Optional[float] = None,
                         scale: Optional[float] = None,
                         k_scales=None, v_scales=None,
                         v_dim: Optional[int] = None,
                         prefetch=None) -> torch.Tensor:
    """Launch ``csrc/paged_attention.cu`` (the split kernel and, with
    more than one split, the combine kernel) on q's current CUDA stream,
    cut as :func:`paged_plan` says.

    Shapes as :func:`paged_attention_plain`; ``prefetch`` is the
    combined (B, M+1) operand from :func:`decode_prefetch` and replaces
    block_tables / lengths when given.  Block tables, lengths and the
    prefetch operand are int32.  Reads nothing back from the card (the
    call can be captured in a CUDA graph).  Raises on anything the
    kernel does not take — never computes on the CPU."""
    dev = q.device
    if dev.type != "cuda" and not torch.cuda.is_available():
        raise RuntimeError("paged_attention kernel: CUDA is not available")
    if dev.type != "cuda":
        _refuse(f"q must be a CUDA tensor, got {dev}")
    # the messages are built only on a refusal: this runs once a layer of
    # every decode step
    b, h, hd = q.shape
    num_pages, ps, kk, k_hd = k_pages.shape
    v_ld = v_pages.shape[-1]
    vd = v_dim if v_dim is not None else v_ld
    if k_hd != hd:
        _refuse(f"k head_dim {k_hd} != q head_dim {hd}")
    if v_pages.shape[:3] != (num_pages, ps, kk):
        _refuse(f"v_pages {tuple(v_pages.shape)} vs k_pages "
                f"{tuple(k_pages.shape)}")
    if h % kk:
        _refuse(f"{h} query heads not a multiple of {kk} kv heads")
    g = h // kk
    if not 0 < vd <= v_ld:
        _refuse(f"v_dim {vd} outside (0, {v_ld}]")
    if hd > MAX_HEAD_DIM:
        _refuse(f"head_dim {hd} > {MAX_HEAD_DIM}")
    if vd > MAX_GROUP_OUT:
        _refuse(f"v_dim {vd} > {MAX_GROUP_OUT}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        _refuse(f"q dtype {q.dtype} not float32/bfloat16")
    if k_pages.dtype not in _DTYPE_CODE or v_pages.dtype != k_pages.dtype:
        _refuse(f"page dtypes {k_pages.dtype}/{v_pages.dtype}")
    quantized = k_pages.dtype == torch.int8
    tensors = [q, k_pages, v_pages]
    if quantized:
        if k_scales is None or v_scales is None:
            _refuse("int8 pages need k_scales and v_scales")
        for s in (k_scales, v_scales):
            if s.dtype != torch.bfloat16 or s.shape != (num_pages, ps, kk):
                _refuse(f"scales must be bf16 {(num_pages, ps, kk)}, got "
                        f"{s.dtype} {tuple(s.shape)}")
        tensors += [k_scales, v_scales]
    if prefetch is not None:
        m = prefetch.shape[1] - 1
        if prefetch.shape != (b, m + 1) or prefetch.dtype != torch.int32:
            _refuse(f"prefetch must be int32 ({b}, M+1), got "
                    f"{prefetch.dtype} {tuple(prefetch.shape)}")
        tensors.append(prefetch)
        bt_ptr, bt_stride = prefetch.data_ptr(), m + 1
        len_ptr, len_stride = prefetch.data_ptr() + 4 * m, m + 1
    else:
        m = block_tables.shape[1]
        if (block_tables.shape != (b, m)
                or block_tables.dtype != torch.int32):
            _refuse(f"block_tables must be int32 ({b}, M), got "
                    f"{block_tables.dtype} {tuple(block_tables.shape)}")
        if lengths.numel() != b or lengths.dtype != torch.int32:
            _refuse(f"lengths must be int32 ({b},), got {lengths.dtype} "
                    f"{tuple(lengths.shape)}")
        tensors += [block_tables, lengths]
        bt_ptr, bt_stride = block_tables.data_ptr(), m
        len_ptr, len_stride = lengths.data_ptr(), 1
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            _refuse(f"operands must be contiguous and on q's device {dev}, "
                    f"got one on {t.device}")
    out = torch.empty((b, h, vd), dtype=q.dtype, device=dev)
    if b == 0:
        return out
    plan = paged_plan(b, kk, g, m, ps, hd, vd, k_pages.element_size(),
                      quantized, sm_count(dev.index), smem_optin(dev.index))
    n_part = scratch_floats(plan, b, kk, g, vd)
    part = (torch.empty((n_part,), dtype=torch.float32, device=dev)
            if n_part else None)
    ml_ptr = part.data_ptr() if part is not None else None
    acc_ptr = (ml_ptr + 4 * 2 * b * kk * plan.num_splits * g
               if part is not None else None)
    scale_ = scale if scale is not None else 1.0 / math.sqrt(hd)
    rc = _launcher()(
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype], q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None,
        bt_ptr, bt_stride, len_ptr, len_stride, ml_ptr, acc_ptr,
        out.data_ptr(), b, kk, g, hd, v_ld, vd, ps, m, plan.pages_per_split,
        plan.num_splits, plan.tile, plan.smem_bytes, plan.head_tiles,
        tile_heads(g, plan.head_tiles), float(scale_),
        float(logit_cap) if logit_cap is not None else 0.0,
        int(window) if window is not None else 0,
        int(chunk) if chunk is not None else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    return out
