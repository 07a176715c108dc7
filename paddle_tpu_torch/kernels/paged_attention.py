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

int8 pools hold codes with one float32 scale per (page, kv head),
``kv_scales = (kscale, vscale)`` of shape [N, kvh]; a key of page ``p``
and kv head ``h`` is ``code * kscale[p, h]``.

:func:`paged_decode_attention` launches ``csrc/paged_decode.cu`` (or
``csrc/paged_decode_int8.cu`` with ``kv_scales``) for CUDA tensors and
runs :func:`paged_attn_reference` (:func:`paged_attn_reference_int8`)
for CPU tensors. The CUDA side is two launches: split-KV partials over
:data:`DECODE_SPLIT_KEYS`-key splits into a workspace, then their merge;
:func:`decode_attn_partials` and :func:`merge_softmax_partials` are the
plain versions of the two passes.

The mixed launch serves prefill chunks, verify windows and decode
tokens of many rows at once: q [B, T, kvh, G, hd] holds each row's
window LEFT-aligned, ``q_lens`` [B] its valid queries and ``kv_lens``
[B] the resident keys INCLUDING the window's own (its K/V are written
before the launch). Query i of row b sits at ``kv_lens[b] - q_lens[b]
+ i`` and attends to every resident position up to its own.
:func:`mixed_paged_attention` launches ``csrc/mixed_paged.cu`` for CUDA
tensors with fp pools and runs :func:`mixed_attn_reference` otherwise
(int8 pools take that gather path on every device, as the reference's
do). The CUDA side is two launches: split-KV partials over
:data:`MIXED_SPLIT_KEYS`-key splits into a workspace, then their merge;
:func:`mixed_attn_partials` and :func:`merge_softmax_partials` are the
plain versions of the two passes. bf16 and fp16 take the tensor-core
kernel, fp32 the CUDA-core one (:func:`mixed_route`), counted in
:data:`route_counts`.
"""

from __future__ import annotations

import collections
import ctypes

from . import _build

__all__ = ["NULL_PAGE", "KV_SCALE_EPS", "launch_counts", "route_counts",
           "paged_attn_reference", "paged_attn_reference_int8",
           "int8_block_update", "gather_pages_dequant",
           "paged_decode_attention", "check_kernel_args",
           "decode_attn_partials", "decode_splits",
           "decode_workspace_floats", "DECODE_SPLIT_KEYS",
           "mixed_attn_reference", "mixed_attn_partials",
           "merge_softmax_partials", "mixed_paged_attention",
           "mixed_route", "mixed_splits", "mixed_workspace_floats",
           "verify_chunk_scores", "check_mixed_args", "MIXED_SPLIT_KEYS",
           "KERNEL_HEAD_DIMS", "KERNEL_BLOCK_SIZES", "KERNEL_MAX_GROUP"]

#: page id 0 is never allocated: padded block-table entries and inactive
#: rows read and write it, so every step has fixed shapes.
NULL_PAGE = 0

#: floor of the per-(page, kv head) int8 scales: a fresh or recycled
#: page starts here, so its first token sets the scale to amax / 127.
KV_SCALE_EPS = 1e-8

#: launches of each kernel of this module, by kernel name. A wrapper
#: adds one where it launches its kernel and nowhere else; a caller
#: that wants to see what a run launched clears it first.
launch_counts: collections.Counter = collections.Counter()

#: the mixed launches by ``"mixed_paged/<route>"`` (``tensor_core`` for
#: bf16 and fp16, ``cuda_core`` for fp32), kept beside ``launch_counts``
route_counts: collections.Counter = collections.Counter()

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_BLOCK_SIZES = (8, 16, 32)
KERNEL_MAX_GROUP = 8

#: keys of one split of the mixed kernel (``kSplit`` in
#: ``csrc/mixed_paged.cu``)
MIXED_SPLIT_KEYS = 256

#: keys of one split of the paged-decode kernels (``kSplit`` in
#: ``csrc/paged_decode.cuh``; ``csrc/paged_decode.cu`` says why 64)
DECODE_SPLIT_KEYS = 64

_KERNEL = "paged_decode"
_KERNEL_INT8 = "paged_decode_int8"
_KERNEL_MIXED = "mixed_paged"

#: the finite "minus infinity" of the online softmax, as in the kernels
_NEG_INF = -1e30


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


def int8_block_update(q, kc, vc, ks, vs, m, l, acc, k_ids, n, sm_scale):
    """ONE page of the int8 online softmax, the reference's
    ``_int8_block_update``: dequantize the page's codes with their
    scales, then fold the page into the running (m, l, acc).

    q [..., G, hd] f32; kc/vc [..., bs, hd] int8 codes; ks/vs [...]
    f32 scales; m, l [..., G]; acc [..., G, hd]; k_ids [..., G, bs]
    absolute key positions and n [..., 1, 1] row lengths (any shapes
    that broadcast so). The leading dims may be empty (one cell, as in
    the reference) or (row, kv head) to fold one page of every cell."""
    import torch
    k = kc.float() * ks[..., None, None]
    v = vc.float() * vs[..., None, None]
    s = (q @ k.transpose(-1, -2)) * sm_scale                # [..., G, bs]
    valid = k_ids < n
    s = torch.where(valid, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    p = torch.where(valid, p, 0.0)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + p @ v
    return m_new, l, acc


def paged_attn_reference_int8(q, k_pages, v_pages, block_table, seq_lens,
                              kv_scales):
    """The plain version of the int8 kernel and the math of the
    reference's ``_paged_attn_reference_int8``: a block-looped online
    softmax that walks the pages in order through
    :func:`int8_block_update`, one page of every (row, kv head) per
    step. A row that has run out of pages sees only masked keys, which
    leave its state exactly as it was, so the rows walk together. A row
    of length 0 gives zeros."""
    import torch
    kscale, vscale = (s.float() for s in kv_scales)
    B, kvh, G, hd = q.shape
    mb = block_table.shape[1]
    bs = k_pages.shape[1]
    dev = q.device
    lens = seq_lens.to(dev).long()
    n_blk = min(mb, -(-int(lens.max()) // bs)) if B else 0
    qf = q.float()
    m = torch.full((B, kvh, G), _NEG_INF, device=dev)
    l = torch.zeros((B, kvh, G), device=dev)
    acc = torch.zeros((B, kvh, G, hd), device=dev)
    n = lens[:, None, None, None]
    slots = torch.arange(bs, device=dev)
    for j in range(n_blk):
        page = block_table[:, j].to(dev).long()
        kc = k_pages[page].transpose(1, 2)               # [B, kvh, bs, hd]
        vc = v_pages[page].transpose(1, 2)
        k_ids = (j * bs + slots).expand(B, kvh, G, bs)
        m, l, acc = int8_block_update(qf, kc, vc, kscale[page],
                                      vscale[page], m, l, acc, k_ids, n,
                                      1.0 / (hd ** 0.5))
    return acc / torch.clamp(l, min=1e-30)[..., None]


def gather_pages_dequant(pages, block_table, scales):
    """Gather a row's int8 code pages and their per-(page, kv head)
    scales, dequantized: pages [N, bs, kvh, hd] int8, block_table
    [B, max_blocks], scales [N, kvh] f32 -> [B, max_blocks*bs, kvh, hd]
    f32. The NULL-page tail dequantizes with page 0's scale; the row's
    length masks it downstream."""
    B, mb = block_table.shape
    flat = block_table.reshape(-1).long()
    g = pages[flat].float() * scales[flat][:, None, :, None].float()
    return g.reshape(B, mb * pages.shape[1], *pages.shape[2:])


def decode_attn_partials(q, k_pages, v_pages, block_table, seq_lens,
                         split_keys=DECODE_SPLIT_KEYS, kv_scales=None):
    """The plain version of the paged-decode kernels' first pass: the
    keys of the block table's width are cut into splits of
    ``split_keys``, and each split gives every query head the
    unnormalised softmax state of its row's keys there, with the
    kernels' arithmetic: scores multiplied by 1/sqrt(hd); with
    ``kv_scales``, the dot product on the raw codes scaled once per key
    by kscale/sqrt(hd), and p scaled by vscale before it weights the
    value codes. Returns (m, l) [n_splits, B, kvh, G] and acc
    [n_splits, B, kvh, G, hd], fp32; a split with no key of its row
    gives m = -1e30, l = 0, acc = 0. :func:`merge_softmax_partials`
    over dim 0 finishes :func:`paged_attn_reference`'s function
    (:func:`paged_attn_reference_int8`'s with ``kv_scales``)."""
    import torch
    B, kvh, G, hd = q.shape
    mb, bs = block_table.shape[1], k_pages.shape[1]
    dev = q.device
    idx = block_table.reshape(-1).long()
    ck = k_pages[idx].reshape(B, mb * bs, kvh, hd).float()
    cv = v_pages[idx].reshape(B, mb * bs, kvh, hd).float()
    sm_scale = 1.0 / hd ** 0.5
    if kv_scales is None:
        kscale = vscale = None
    else:                       # per key [B, kvh, mb * bs]
        kscale, vscale = (s.float()[idx].reshape(B, mb, kvh)
                          .repeat_interleave(bs, dim=1).transpose(1, 2)
                          for s in kv_scales)
    n = seq_lens.to(dev).long()
    qf = q.float()
    ms, ls, accs = [], [], []
    for k0 in range(0, mb * bs, split_keys):
        k1 = min(k0 + split_keys, mb * bs)
        j = torch.arange(k0, k1, device=dev)
        ok = (j[None, :] < n[:, None])[:, None, None, :]    # [B, 1, 1, t]
        s = torch.einsum("bngd,btnd->bngt", qf, ck[:, k0:k1])
        if kscale is None:
            s = s * sm_scale
        else:
            s = s * (kscale[:, :, k0:k1] * sm_scale)[:, :, None, :]
        s = torch.where(ok, s, _NEG_INF)
        m = s.amax(-1)
        p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        if vscale is not None:
            p = p * vscale[:, :, None, k0:k1]
        accs.append(torch.einsum("bngt,btnd->bngd", p, cv[:, k0:k1]))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def decode_splits(max_blocks, bs):
    """Splits of the paged-decode kernels' first pass:
    ceil(max_blocks * bs / DECODE_SPLIT_KEYS), from the block table's
    width alone."""
    return -(-max_blocks * bs // DECODE_SPLIT_KEYS)


def decode_workspace_floats(B, kvh, G, hd, max_blocks, bs):
    """fp32 elements of the paged-decode kernels' workspace: each
    split's acc [B, kvh, G, hd], then each split's (m, l)."""
    return decode_splits(max_blocks, bs) * B * kvh * G * (hd + 2)


def check_kernel_args(q, k_pages, v_pages, block_table, seq_lens,
                      kv_scales=None):
    """Raise ``ValueError`` unless the CUDA kernel takes these
    arguments: the shapes below, contiguous 16-byte-aligned data, int32
    table and lengths, one device; q in bf16, fp16 or fp32 with pools of
    q's type, or, with ``kv_scales``, int8 pools and float32 scales
    [N, kvh] (the int8 kernel)."""
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
    pool_dtype = q.dtype if kv_scales is None else torch.int8
    if k_pages.dtype != pool_dtype or v_pages.dtype != pool_dtype:
        raise ValueError(f"pools must be {pool_dtype} for q of {q.dtype}; "
                         f"got {k_pages.dtype}, {v_pages.dtype}")
    scales = ()
    if kv_scales is not None:
        scales = tuple(kv_scales)
        if len(scales) != 2 or any(
                sc.dtype != torch.float32 or tuple(sc.shape) != (N, kvh)
                for sc in scales):
            raise ValueError(f"kv_scales must be two float32 [{N}, {kvh}] "
                             f"tensors")
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
    args = (q, k_pages, v_pages, block_table, seq_lens) + scales
    if any(not a.is_contiguous() for a in args):
        raise ValueError("q, pools, scales, block_table and seq_lens must "
                         "be contiguous")
    if any(a.data_ptr() % 16 for a in args[:3]):
        raise ValueError("q and the pools must be 16-byte aligned")
    if len({a.device for a in args}) != 1:
        raise ValueError("all arguments must be on one device")


def _bind(lib):
    fn = lib.paged_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _bind_int8(lib):
    fn = lib.paged_decode_int8_attention
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _launch(q, k_pages, v_pages, block_table, seq_lens, kv_scales=None):
    """Launch the fp kernel, or the int8 kernel with ``kv_scales`` (split
    pass and merge), on the current stream, with its workspace from
    torch's allocator on that stream; count it once."""
    import torch
    check_kernel_args(q, k_pages, v_pages, block_table, seq_lens,
                      kv_scales)
    B, kvh, G, hd = q.shape
    bs, mb = k_pages.shape[1], block_table.shape[1]
    out = torch.empty((B, kvh, G, hd), dtype=torch.float32,
                      device=q.device)
    n_ws = decode_workspace_floats(B, kvh, G, hd, mb, bs)
    ws = torch.empty((n_ws,), dtype=torch.float32, device=q.device)
    shape = (n_ws, B, kvh, G, hd, bs, mb, _build.DTYPE_CODE[str(q.dtype)],
             1.0 / (hd ** 0.5))
    if kv_scales is None:
        name = _KERNEL
        fn = _build.load(name, _bind).paged_decode_attention
        ptrs = (q, k_pages, v_pages, block_table, seq_lens, out, ws)
    else:
        name = _KERNEL_INT8
        fn = _build.load(name, _bind_int8).paged_decode_int8_attention
        ptrs = (q, k_pages, v_pages, *kv_scales, block_table, seq_lens,
                out, ws)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(a.data_ptr() for a in ptrs), *shape, stream)
    if err != 0:
        why = "unsupported arguments" if err < 0 else "cudaError_t"
        raise RuntimeError(f"{name} launch failed: {why} {err}")
    launch_counts[name] += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, block_table, seq_lens,
                           kv_scales=None):
    """Decode attention over a paged KV cache: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. ``kv_scales=(kscale,
    vscale)`` ([N, kvh] f32 each) selects the int8 kernel, whose pools
    hold int8 codes dequantized inside it. On CUDA it launches the
    kernel or raises; it never falls back."""
    dev = q.device.type
    if dev == "cuda":
        return _launch(q, k_pages, v_pages, block_table, seq_lens,
                       kv_scales)
    if dev == "cpu":
        if kv_scales is not None:
            return paged_attn_reference_int8(q, k_pages, v_pages,
                                             block_table, seq_lens,
                                             kv_scales)
        return paged_attn_reference(q, k_pages, v_pages, block_table,
                                    seq_lens)
    raise ValueError(f"paged_decode_attention: no kernel for device "
                     f"{q.device}")


# -- the mixed prefill-chunk + decode launch ---------------------------------

def mixed_attn_reference(q, k_pages, v_pages, block_table, kv_lens, q_lens,
                         kv_scales=None):
    """Gather the rows' pages, then one softmax under each query's
    causal limit: the math of the reference's ``_mixed_attn_reference``
    (``-inf`` mask, an ``isfinite`` guard, division by sqrt(hd)).
    q [B, T, kvh, G, hd]; returns [B, T, kvh, G, hd] float32. Padding
    queries (i >= q_lens[b]) attend to every resident key (finite
    garbage nobody reads); a row with kv_len 0 gives exact zeros.
    ``kv_scales`` dequantizes int8 pools on the gather."""
    import torch
    B, T, kvh, G, hd = q.shape
    if kv_scales is not None:
        ck = gather_pages_dequant(k_pages, block_table, kv_scales[0])
        cv = gather_pages_dequant(v_pages, block_table, kv_scales[1])
    else:
        mb, bs = block_table.shape[1], k_pages.shape[1]
        idx = block_table.reshape(-1).long()
        ck = k_pages[idx].reshape(B, mb * bs, kvh, hd)
        cv = v_pages[idx].reshape(B, mb * bs, kvh, hd)
    dev = q.device
    kv_lens, q_lens = kv_lens.to(dev).long(), q_lens.to(dev).long()
    pos = (kv_lens[:, None] - q_lens[:, None]
           + torch.arange(T, device=dev)[None, :])          # [B, T]
    j = torch.arange(ck.shape[1], device=dev)[None, None, :]
    ok = (j <= pos[:, :, None]) & (j < kv_lens[:, None, None])
    s = torch.einsum("btngd,bsnd->btngs", q.float(), ck.float()) / hd ** 0.5
    s = s.masked_fill(~ok[:, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isfinite(s).any(-1, keepdim=True), p,
                    torch.zeros((), dtype=p.dtype, device=dev))
    return torch.einsum("btngs,bsnd->btngd", p, cv.float())


def mixed_attn_partials(q, k_pages, v_pages, block_table, kv_lens, q_lens,
                        split_keys=MIXED_SPLIT_KEYS):
    """The plain version of the mixed kernel's first pass: the keys of
    the block table's width are cut into splits of ``split_keys``, and
    each split gives every query the unnormalised online-softmax state
    of its visible keys there, scores multiplied by 1/sqrt(hd) as in the
    kernel: (m, l) [n_splits, B, T, kvh, G] and acc [n_splits, B, T,
    kvh, G, hd], fp32. A split with no key visible to a query gives it
    m = -1e30, l = 0, acc = 0. :func:`merge_softmax_partials` over
    dim 0 finishes :func:`mixed_attn_reference`'s function."""
    import torch
    B, T, kvh, G, hd = q.shape
    mb, bs = block_table.shape[1], k_pages.shape[1]
    idx = block_table.reshape(-1).long()
    ck = k_pages[idx].reshape(B, mb * bs, kvh, hd).float()
    cv = v_pages[idx].reshape(B, mb * bs, kvh, hd).float()
    dev = q.device
    kv_lens, q_lens = kv_lens.to(dev).long(), q_lens.to(dev).long()
    pos = (kv_lens[:, None] - q_lens[:, None]
           + torch.arange(T, device=dev)[None, :])          # [B, T]
    qf = q.float()
    ms, ls, accs = [], [], []
    for k0 in range(0, mb * bs, split_keys):
        kb, vb = ck[:, k0:k0 + split_keys], cv[:, k0:k0 + split_keys]
        j = torch.arange(k0, k0 + kb.shape[1], device=dev)[None, None, :]
        ok = ((j <= pos[:, :, None]) & (j < kv_lens[:, None, None])
              )[:, :, None, None, :]
        s = torch.einsum("btngd,bsnd->btngs", qf, kb) * (1.0 / hd ** 0.5)
        s = torch.where(ok, s, _NEG_INF)
        m = s.amax(-1)
        p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("btngs,bsnd->btngd", p, vb))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def merge_softmax_partials(m, l, acc, dim=0):
    """Combine online-softmax partials along ``dim`` (the splits of a
    row's keys, or shards of a mesh axis): m, l [...], acc [..., hd] ->
    [..., hd]. The math of the reference's ``merge_softmax_partials``:
    M = max m, w = exp(m - M), L = sum l w, out = sum acc w / max(L,
    1e-30), so a partial with m = -1e30, l = 0, acc = 0 adds nothing and
    a query with no key anywhere gets exact zeros. The plain version of
    the mixed kernel's second pass."""
    import torch
    M = m.amax(dim, keepdim=True)
    w = torch.exp(m - M)
    L = (l * w).sum(dim)
    out = (acc * w[..., None]).sum(dim)
    return out / torch.clamp(L, min=1e-30)[..., None]


def mixed_route(dtype):
    """The mixed kernel's route for CUDA inputs of ``dtype``:
    "tensor_core" for bf16 and fp16, else "cuda_core"."""
    import torch
    if dtype in (torch.bfloat16, torch.float16):
        return "tensor_core"
    return "cuda_core"


def mixed_splits(max_blocks, bs):
    """Splits of the mixed kernel's first pass: ceil(max_blocks * bs /
    MIXED_SPLIT_KEYS), from the block table's width alone."""
    return -(-max_blocks * bs // MIXED_SPLIT_KEYS)


def mixed_workspace_floats(B, T, kvh, G, hd, max_blocks, bs):
    """fp32 elements of the mixed kernel's workspace: each split's acc
    [B, kvh, T * G, hd], then each split's (m, l)."""
    return mixed_splits(max_blocks, bs) * B * kvh * T * G * (hd + 2)


def check_mixed_args(q, k_pages, v_pages, block_table, kv_lens, q_lens):
    """Raise ``ValueError`` unless the mixed CUDA kernel takes these
    arguments: q [B, T, kvh, G, hd] in bf16, fp16 or fp32, pools
    [N, bs, kvh, hd] of q's type, int32 table [B, max_blocks >= 1] and
    lengths [B], contiguous and 16-byte aligned, one device; head dims,
    block sizes and group sizes as the decode kernel's."""
    import torch
    if q.dim() != 5 or k_pages.dim() != 4:
        raise ValueError(f"q must be [B, T, kvh, G, hd] and pages "
                         f"[N, bs, kvh, hd]; got {tuple(q.shape)} and "
                         f"{tuple(k_pages.shape)}")
    B, T, kvh, G, hd = q.shape
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
        raise ValueError(f"pools must be {q.dtype}; got {k_pages.dtype}, "
                         f"{v_pages.dtype}")
    if any(t.dtype != torch.int32 for t in (block_table, kv_lens, q_lens)):
        raise ValueError("block_table, kv_lens and q_lens must be int32")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(kv_lens.shape) != (B,) or tuple(q_lens.shape) != (B,):
        raise ValueError(f"block_table must be [{B}, max_blocks], kv_lens "
                         f"and q_lens [{B}]; got {tuple(block_table.shape)},"
                         f" {tuple(kv_lens.shape)}, {tuple(q_lens.shape)}")
    if block_table.shape[1] < 1 or T < 1:
        raise ValueError("block_table needs a column and q a query slot")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {KERNEL_HEAD_DIMS}")
    if not 1 <= G <= KERNEL_MAX_GROUP:
        raise ValueError(f"query group G={G} not in 1..{KERNEL_MAX_GROUP}")
    if bs not in KERNEL_BLOCK_SIZES:
        raise ValueError(f"block size {bs} not in {KERNEL_BLOCK_SIZES}")
    args = (q, k_pages, v_pages, block_table, kv_lens, q_lens)
    if any(not a.is_contiguous() for a in args):
        raise ValueError("q, pools, block_table and lengths must be "
                         "contiguous")
    if any(a.data_ptr() % 16 for a in args[:3]):
        raise ValueError("q and the pools must be 16-byte aligned")
    if len({a.device for a in args}) != 1:
        raise ValueError("all arguments must be on one device")


def _bind_mixed(lib):
    fn = lib.mixed_paged_attention
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _call_mixed(fn, args, device):
    """``fn(*args, stream)`` with ``device`` current and its current
    stream: the C entry's call."""
    import torch
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def _launch_mixed(q, k_pages, v_pages, block_table, kv_lens, q_lens):
    """Launch ``csrc/mixed_paged.cu`` (split pass and merge) on the
    current stream, with its workspace from torch's allocator on that
    stream; count it once, by kernel and by route."""
    import torch
    check_mixed_args(q, k_pages, v_pages, block_table, kv_lens, q_lens)
    B, T, kvh, G, hd = q.shape
    bs, mb = k_pages.shape[1], block_table.shape[1]
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    n_ws = mixed_workspace_floats(B, T, kvh, G, hd, mb, bs)
    ws = torch.empty((n_ws,), dtype=torch.float32, device=q.device)
    fn = _build.load(_KERNEL_MIXED, _bind_mixed).mixed_paged_attention
    err = _call_mixed(fn, (*(a.data_ptr() for a in (
        q, k_pages, v_pages, block_table, kv_lens, q_lens, out, ws)),
        n_ws, B, T, kvh, G, hd, bs, mb, _build.DTYPE_CODE[str(q.dtype)],
        1.0 / (hd ** 0.5)), q.device)
    if err != 0:
        why = "unsupported arguments" if err < 0 else "cudaError_t"
        raise RuntimeError(f"{_KERNEL_MIXED} launch failed: {why} {err}")
    launch_counts[_KERNEL_MIXED] += 1
    route_counts[f"{_KERNEL_MIXED}/{mixed_route(q.dtype)}"] += 1
    return out


def mixed_paged_attention(q, k_pages, v_pages, block_table, kv_lens, q_lens,
                          kv_scales=None):
    """Attention of a mixed batch of windows (prefill chunks, verify
    windows, decode tokens) over a paged cache: the CUDA kernel for
    CUDA tensors with fp pools, the plain version for CPU tensors.
    int8 pools (``kv_scales=(kscale, vscale)``) take the plain gather
    path on every device, as the reference's do. On CUDA with fp pools
    it launches the kernel or raises; it never falls back."""
    if kv_scales is not None:
        return mixed_attn_reference(q, k_pages, v_pages, block_table,
                                    kv_lens, q_lens, kv_scales)
    dev = q.device.type
    if dev == "cuda":
        return _launch_mixed(q, k_pages, v_pages, block_table, kv_lens,
                             q_lens)
    if dev == "cpu":
        return mixed_attn_reference(q, k_pages, v_pages, block_table,
                                    kv_lens, q_lens)
    raise ValueError(f"mixed_paged_attention: no kernel for device "
                     f"{q.device}")


def verify_chunk_scores(q, k_pages, v_pages, block_table, kv_lens, q_lens,
                        kv_scales=None):
    """Attention of speculative verify windows: row b's q_lens[b]
    queries are its pending token and its drafts, already written at
    positions ``kv_lens[b] - q_lens[b] .. kv_lens[b] - 1``. That is the
    mixed launch's contract, so this is :func:`mixed_paged_attention`."""
    return mixed_paged_attention(q, k_pages, v_pages, block_table, kv_lens,
                                 q_lens, kv_scales=kv_scales)
