"""Ragged paged-attention decode: the CUDA kernel's Python side and its
plain PyTorch version.

The serving decode path keeps its KV cache in a block pool
``[n_blocks, block_size, kvh, hd]`` with a per-row block table. One
query token per row attends over the row's ragged history, read through
the table:

- q: [B, kvh, G, hd] (the G query heads of each kv head)
- k_pages / v_pages: [N, bs, kvh, hd]; page 0 is the reserved NULL page
  (allocators never hand it out; padded table entries and inactive rows
  point there)
- block_table: [B, max_blocks] int32 page ids
- seq_lens: [B] int32 valid keys per row
- returns [B, kvh, G, hd] float32

:func:`paged_decode_attention` launches ``csrc/paged_decode.cu`` for
CUDA tensors and runs :func:`paged_attn_reference` for CPU tensors.
"""

from __future__ import annotations

import collections
import ctypes

from . import _build

__all__ = ["NULL_PAGE", "KV_SCALE_EPS", "launch_counts",
           "paged_attn_reference", "paged_decode_attention",
           "check_kernel_args", "KERNEL_HEAD_DIMS", "KERNEL_BLOCK_SIZES",
           "KERNEL_MAX_GROUP"]

#: page id 0 is never allocated: padded block-table entries and inactive
#: rows read and write it, so every step has fixed shapes.
NULL_PAGE = 0

#: floor for per-(page, kv head) int8 scales (int8 KV is not ported yet;
#: kept beside NULL_PAGE as in the reference module).
KV_SCALE_EPS = 1e-8

#: launches of each kernel of this module, by kernel name. A wrapper
#: adds one where it launches its kernel and nowhere else; a caller
#: that wants to see what a run launched clears it first.
launch_counts: collections.Counter = collections.Counter()

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_BLOCK_SIZES = (8, 16, 32)
KERNEL_MAX_GROUP = 8

_KERNEL = "paged_decode"


def paged_attn_reference(q, k_pages, v_pages, block_table, seq_lens):
    """Gather the row's pages, then one masked softmax: the math of the
    reference's ``_paged_attn_reference``. A row with no valid key gives
    zeros (the reference's softmax gives NaN there; the TPU kernel and
    the CUDA kernel give zeros)."""
    import torch
    B, mb = block_table.shape
    N, bs, kvh, hd = k_pages.shape
    idx = block_table.reshape(-1).long()
    ck = k_pages[idx].reshape(B, mb * bs, kvh, hd)
    cv = v_pages[idx].reshape(B, mb * bs, kvh, hd)
    mask = (torch.arange(mb * bs, device=q.device)[None, :]
            < seq_lens[:, None].to(q.device))
    s = torch.einsum("bngd,btnd->bngt", q.float(), ck.float())
    s = s / (hd ** 0.5)
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, None, None], p,
                    torch.zeros((), dtype=p.dtype, device=p.device))
    return torch.einsum("bngt,btnd->bngd", p, cv.float())


def check_kernel_args(q, k_pages, v_pages, block_table, seq_lens):
    """Raise ``ValueError`` unless the CUDA kernel takes these
    arguments: matching float types, the shapes below, contiguous
    16-byte-aligned data, int32 table and lengths, one device."""
    import torch
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"q must be [B, kvh, G, hd] and pages "
                         f"[N, bs, kvh, hd]; got {tuple(q.shape)} and "
                         f"{tuple(k_pages.shape)}")
    B, kvh, G, hd = q.shape
    N, bs, pkvh, phd = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(f"k/v pools differ: {tuple(k_pages.shape)} vs "
                         f"{tuple(v_pages.shape)}")
    if (pkvh, phd) != (kvh, hd):
        raise ValueError(f"pool [.., {pkvh}, {phd}] does not match q's "
                         f"kvh={kvh}, hd={hd}")
    if q.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"dtype {q.dtype} not supported")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"q, k_pages, v_pages must share one dtype; got "
                         f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("block_table and seq_lens must be int32")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"block_table must be [{B}, max_blocks] and "
                         f"seq_lens [{B}]; got {tuple(block_table.shape)}"
                         f" and {tuple(seq_lens.shape)}")
    if block_table.shape[1] < 1:
        raise ValueError("block_table needs at least one column")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {KERNEL_HEAD_DIMS}")
    if not 1 <= G <= KERNEL_MAX_GROUP:
        raise ValueError(f"query group G={G} not in 1..{KERNEL_MAX_GROUP}")
    if bs not in KERNEL_BLOCK_SIZES:
        raise ValueError(f"block size {bs} not in {KERNEL_BLOCK_SIZES}")
    args = (q, k_pages, v_pages, block_table, seq_lens)
    if any(not a.is_contiguous() for a in args):
        raise ValueError("q, pools, block_table and seq_lens must be "
                         "contiguous")
    if any(a.data_ptr() % 16 for a in args[:3]):
        raise ValueError("q and the pools must be 16-byte aligned")
    if len({a.device for a in args}) != 1:
        raise ValueError("all arguments must be on one device")


def _bind(lib):
    fn = lib.paged_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int


_DTYPE_CODE = {"torch.float32": 0, "torch.float16": 1, "torch.bfloat16": 2}


def _launch(q, k_pages, v_pages, block_table, seq_lens):
    import torch
    check_kernel_args(q, k_pages, v_pages, block_table, seq_lens)
    lib = _build.load(_KERNEL, _bind)
    B, kvh, G, hd = q.shape
    out = torch.empty((B, kvh, G, hd), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, kvh, G, hd, k_pages.shape[1], block_table.shape[1],
            _DTYPE_CODE[str(q.dtype)], 1.0 / (hd ** 0.5), stream)
    if err != 0:
        why = "unsupported arguments" if err < 0 else "cudaError_t"
        raise RuntimeError(f"paged_decode_attention launch failed: {why} "
                           f"{err}")
    launch_counts[_KERNEL] += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, block_table, seq_lens):
    """Decode attention over a paged KV cache: the CUDA kernel for CUDA
    tensors, :func:`paged_attn_reference` for CPU tensors. On CUDA it
    launches the kernel or raises; it never falls back."""
    dev = q.device.type
    if dev == "cuda":
        return _launch(q, k_pages, v_pages, block_table, seq_lens)
    if dev == "cpu":
        return paged_attn_reference(q, k_pages, v_pages, block_table,
                                    seq_lens)
    raise ValueError(f"paged_decode_attention: no kernel for device "
                     f"{q.device}")
