"""FlashAttention-2, forward and backward: the CUDA kernels' Python side,
their plain PyTorch versions and the differentiable entry points.

Counterpart of ``paddle_tpu/kernels/flash_attention.py``. Layout
[B, S, H, D] for q and the output, [B, S, Hkv, D] for k and v with
H % Hkv == 0 (grouped-query attention; kv head of query head h is
h // (H / Hkv)); the log-sum-exp of each row comes as float32
[B * H, 1, S], as in the reference.

- :func:`flash_fwd_reference` and :func:`flash_bwd_reference` are the
  plain versions. They loop over key blocks with the kernels'
  arithmetic: scores multiplied by D^-1/2, masked keys at the finite
  -1e30, an online softmax in fp32, and the same roundings to the input
  type before each product (P to v's type in the forward, dS to k's type
  for dq, P to dout's type and dS to q's type for dk and dv).
- :func:`sdpa_reference` and :func:`sdpa_reference_with_lse` are the
  reference's XLA path: one grouped einsum, dividing by sqrt(D), P cast
  to q's type before P.V.
- :class:`FlashAttention` binds forward and backward for autograd; it
  launches ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` for CUDA
  tensors and runs the plain versions for CPU tensors. On CUDA it
  launches the kernels or raises; it never falls back.

Routes on CUDA, a fixed function of the input type (:func:`route`):
bf16 and fp16 take the tensor-core kernels (``flash_fwd_mma``,
``flash_dq_mma``, ``flash_dkv_mma``: ``mma.sync`` on tiles in the input
type, and exponentials as 2^x with the scale and log2 e folded in, a few
ulps from the plain versions' exp before P's rounding), fp32 takes the
CUDA-core kernels (``flash_fwd``, ``flash_dq``, ``flash_dkv``: fp32
FMAs, since the tensor cores have no full-fp32 product). A failed launch
raises; neither route gives way to the other or to the plain version.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import _build

__all__ = ["launch_counts", "route_counts", "route", "KERNEL_HEAD_DIMS", "check_args",
           "flash_delta", "flash_fwd_reference", "flash_bwd_reference",
           "sdpa_reference", "sdpa_reference_with_lse", "FlashAttention",
           "flash_attention", "flash_attention_with_lse",
           "flash_attention_fwd"]

#: launches of each kernel of this module, by kernel name (``flash_fwd``,
#: ``flash_dq``, ``flash_dkv``). A wrapper adds one where it launches its
#: kernel and nowhere else; a caller that wants to see what a run
#: launched clears it first.
launch_counts: collections.Counter = collections.Counter()

#: the same launches by ``"<kernel>/<route>"`` (``"flash_fwd/tensor_core"``,
#: ``"flash_dkv/cuda_core"``, ...), kept beside ``launch_counts`` so that
#: a run can show which route its kernels took
route_counts: collections.Counter = collections.Counter()

#: the C entry of each (kernel, route)
_ENTRY = {("flash_fwd", "tensor_core"): "flash_fwd_mma",
          ("flash_fwd", "cuda_core"): "flash_fwd",
          ("flash_dq", "tensor_core"): "flash_dq_mma",
          ("flash_dq", "cuda_core"): "flash_dq",
          ("flash_dkv", "tensor_core"): "flash_dkv_mma",
          ("flash_dkv", "cuda_core"): "flash_dkv"}

KERNEL_HEAD_DIMS = (16, 32, 64, 128)

#: the finite "minus infinity" of the kernels' masks
_NEG_INF = -1e30

#: key-block sizes of the kernels, which the plain versions follow
_FWD_BLOCK = 64
_BWD_BLOCK = 32


def check_args(q, k, v):
    """Raise ``ValueError`` unless these are arguments of the kernels (on
    CUDA) or of their plain versions (on the CPU): q [B, S, H, D] and
    k, v [B, S, Hkv, D] with H % Hkv == 0 and D in
    :data:`KERNEL_HEAD_DIMS`; one device and one type, bf16, fp16 or
    fp32 (and float64 on the CPU, for gradient checks)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, S, heads, D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != B \
            or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k and v must be [{B}, {S}, Hkv, {D}]; got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    Hkv = k.shape[2]
    if Hkv < 1 or H % Hkv != 0:
        raise ValueError(f"query heads ({H}) must be a multiple of "
                         f"key/value heads ({Hkv})")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {KERNEL_HEAD_DIMS}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"q, k, v must be on one device; got {q.device}, "
                         f"{k.device}, {v.device}")
    if len({q.dtype, k.dtype, v.dtype}) != 1:
        raise ValueError(f"q, k, v must share a type; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    types = (torch.bfloat16, torch.float16, torch.float32)
    if q.device.type == "cpu":
        types += (torch.float64,)
    if q.dtype not in types:
        raise ValueError(f"dtype {q.dtype} not supported on {q.device}")


def _acc_dtype(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _grouped(x, G):
    """[B, S, heads, D] -> [B, heads // G, G, S, D] in the accumulation
    type."""
    B, S, nh, D = x.shape
    return x.to(_acc_dtype(x)).permute(0, 2, 1, 3).reshape(
        B, nh // G, G, S, D)


def _heads(x):
    """[B, Hkv, G, S, D] -> [B, S, Hkv * G, D]."""
    B, n, G, S, D = x.shape
    return x.reshape(B, n * G, S, D).permute(0, 2, 1, 3)


def _block_scores(qg, kb, k0, causal, scale):
    """Scaled scores of every query against keys [k0, k0 + n) of one
    block, the masked ones at -1e30: [B, Hkv, G, S, n]."""
    s = torch.einsum("bngsd,bntd->bngst", qg, kb) * scale
    if causal:
        S, n = qg.shape[3], kb.shape[2]
        qi = torch.arange(S, device=qg.device)[:, None]
        kj = k0 + torch.arange(n, device=qg.device)[None, :]
        s = s.masked_fill(kj > qi, _NEG_INF)
    return s


def flash_fwd_reference(q, k, v, causal=False, block=_FWD_BLOCK):
    """The forward kernel's plain version: (out [B, S, H, D] in q's
    type, lse [B * H, 1, S] f32). An online softmax over key blocks of
    ``block``; a block wholly past a row's causal diagonal leaves its
    state exactly as it was (every row sees key 0 in the first block),
    so all rows walk every block together."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    scale = 1.0 / (D ** 0.5)
    qg = _grouped(q, G)
    kf = _grouped(k, 1)[:, :, 0]                       # [B, Hkv, S, D]
    vf = _grouped(v, 1)[:, :, 0]
    acc_t = qg.dtype
    m = torch.full(qg.shape[:-1], _NEG_INF, dtype=acc_t, device=q.device)
    l = torch.zeros(qg.shape[:-1], dtype=acc_t, device=q.device)
    acc = torch.zeros(qg.shape, dtype=acc_t, device=q.device)
    for k0 in range(0, S, block):
        kb, vb = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
        s = _block_scores(qg, kb, k0, causal, scale)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bngst,bntd->bngsd", p.to(v.dtype).to(acc_t), vb)
        m = m_new
    ls = torch.clamp(l, min=1e-30)
    out = _heads(acc / ls[..., None]).to(q.dtype)
    lse = (m + torch.log(ls)).reshape(B * H, 1, S)
    return out, lse


def flash_delta(out, dout, g_lse=None):
    """delta = rowsum(dout * out) - g_lse in f32, [B * H, 1, S]: the
    reference's XLA step before the backward kernels. The lse cotangent
    ``g_lse`` ([B * H, 1, S]) folds in here, since d lse_i / d s_ij =
    p_ij."""
    B, S, H, _ = out.shape
    acc_t = _acc_dtype(out)
    delta = (dout.to(acc_t) * out.to(acc_t)).sum(-1)          # [B, S, H]
    delta = delta.permute(0, 2, 1).reshape(B * H, 1, S)
    if g_lse is not None:
        delta = delta - g_lse.to(acc_t)
    return delta


def flash_bwd_reference(q, k, v, out, lse, dout, causal=False, g_lse=None,
                        block=_BWD_BLOCK):
    """The backward kernels' plain version: (dq, dk, dv) in q's, k's and
    v's types, from the forward's (out, lse) and the cotangents ``dout``
    and ``g_lse`` (None for none). One loop over key blocks computes all
    three, with dq's roundings (dS to k's type) and dk/dv's (P to dout's
    type, dS to q's type) kept apart as in the two kernels."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / (D ** 0.5)
    qg, dog = _grouped(q, G), _grouped(dout, G)
    kf = _grouped(k, 1)[:, :, 0]
    vf = _grouped(v, 1)[:, :, 0]
    acc_t = qg.dtype
    lse_g = lse.to(acc_t).reshape(B, Hkv, G, S)[..., None]
    delta = flash_delta(out, dout, g_lse).reshape(B, Hkv, G, S)[..., None]
    dq = torch.zeros_like(qg)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for k0 in range(0, S, block):
        kb, vb = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
        p = torch.exp(_block_scores(qg, kb, k0, causal, scale) - lse_g)
        dp = torch.einsum("bngsd,bntd->bngst", dog, vb)
        ds_q = (p * (dp - delta)).to(k.dtype).to(acc_t)
        dq += torch.einsum("bngst,bntd->bngsd", ds_q, kb)
        p_r = p.to(dout.dtype).to(acc_t)
        ds_k = (p_r * (dp - delta)).to(q.dtype).to(acc_t)
        dv[:, :, k0:k0 + block] = torch.einsum("bngst,bngsd->bntd", p_r, dog)
        dk[:, :, k0:k0 + block] = torch.einsum("bngst,bngsd->bntd", ds_k,
                                               qg)
    dq = _heads(dq * scale).to(q.dtype)
    dk = _heads((dk * scale)[:, :, None]).to(k.dtype)
    dv = _heads(dv[:, :, None]).to(v.dtype)
    return dq, dk, dv


def _sdpa_scores(q, k, causal):
    """The reference's grouped scores: [B, Hkv, G, S, S] in f32 (f64 for
    f64 inputs), divided by sqrt(D), masked at -1e30."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if H % Hkv != 0:
        raise ValueError(f"query heads ({H}) must be a multiple of "
                         f"key/value heads ({Hkv}) for grouped-query "
                         f"attention")
    qh = q.permute(0, 2, 1, 3).reshape(B, Hkv, H // Hkv, S, D)
    s = torch.einsum("bngsd,bntd->bngst", qh, k.permute(0, 2, 1, 3))
    s = s.to(_acc_dtype(q)) / (D ** 0.5)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return s


def _sdpa_out(p, v, shape):
    B, S, H, D = shape
    out = torch.einsum("bngst,bntd->bngsd", p, v.permute(0, 2, 1, 3))
    return out.reshape(B, H, S, D).permute(0, 2, 1, 3)


def sdpa_reference(q, k, v, causal=False):
    """The reference's ``_sdpa_reference``: grouped einsum, scores in
    f32 divided by sqrt(D), masked at -1e30, softmax, P cast to q's type
    before P.V."""
    p = torch.softmax(_sdpa_scores(q, k, causal), dim=-1).to(q.dtype)
    return _sdpa_out(p, v, q.shape)


def sdpa_reference_with_lse(q, k, v, causal=False):
    """The reference's ``_sdpa_reference_with_lse``: (out [B, S, H, D],
    lse [B * H, 1, S]), differentiable by autograd."""
    B, S, H, _ = q.shape
    s = _sdpa_scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(q.dtype)
    return _sdpa_out(p, v, q.shape), lse.reshape(B * H, 1, S)


# -- kernels ------------------------------------------------------------------

def route(name, dtype):
    """The route of kernel ``name`` (``flash_fwd``, ``flash_dq`` or
    ``flash_dkv``) for CUDA inputs of ``dtype``: "tensor_core" for bf16
    and fp16, else "cuda_core"."""
    if dtype in (torch.bfloat16, torch.float16):
        return "tensor_core"
    return "cuda_core"


def _bind(lib, names, n_ptrs):
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int


def _bind_fwd(lib):
    _bind(lib, ("flash_fwd", "flash_fwd_mma"), 5)


def _bind_bwd(lib):
    _bind(lib, ("flash_dq", "flash_dq_mma"), 7)
    _bind(lib, ("flash_dkv", "flash_dkv_mma"), 8)


def _call(fn, args, device):
    """``fn(*args, stream)`` with ``device`` current and its current
    stream: a C entry's call."""
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def _run(name, lib, tensors, q, k, causal):
    """Launch kernel ``name`` of ``lib`` by the route of q's type on the
    data of ``tensors`` and the shape arguments of (q, k), on the current
    stream; raise on an error; count the launch under ``name`` and
    ``name/route``."""
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: arguments must be contiguous")
    way = route(name, q.dtype)
    if way == "tensor_core" and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the tensor-core kernel copies 16-byte "
                         f"chunks; arguments must be 16-byte aligned")
    B, S, H, D = q.shape
    shape = (B, S, H, k.shape[2], D, _build.DTYPE_CODE[str(q.dtype)],
             int(bool(causal)), 1.0 / (D ** 0.5))
    err = _call(getattr(lib, _ENTRY[(name, way)]),
                (*(t.data_ptr() for t in tensors), *shape), q.device)
    if err != 0:
        why = "unsupported arguments" if err < 0 else "cudaError_t"
        raise RuntimeError(f"{name} ({way}) launch failed: {why} {err}")
    launch_counts[name] += 1
    route_counts[f"{name}/{way}"] += 1


def _fwd_kernel(q, k, v, causal):
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B * H, 1, S), dtype=torch.float32, device=q.device)
    _run("flash_fwd", _build.load("flash_fwd", _bind_fwd),
         (q, k, v, out, lse), q, k, causal)
    return out, lse


def _dq_kernel(q, k, v, dout, lse, delta, causal):
    dq = torch.empty_like(q)
    _run("flash_dq", _build.load("flash_bwd", _bind_bwd),
         (q, k, v, dout, lse, delta, dq), q, k, causal)
    return dq


def _dkv_kernel(q, k, v, dout, lse, delta, causal):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _run("flash_dkv", _build.load("flash_bwd", _bind_bwd),
         (q, k, v, dout, lse, delta, dk, dv), q, k, causal)
    return dk, dv


def _bwd_kernels(q, k, v, out, lse, dout, causal, g_lse):
    delta = flash_delta(out, dout, g_lse).contiguous()
    lse = lse.contiguous()
    dq = _dq_kernel(q, k, v, dout, lse, delta, causal)
    return (dq, *_dkv_kernel(q, k, v, dout, lse, delta, causal))


def _fwd(q, k, v, causal):
    if q.device.type == "cuda":
        return _fwd_kernel(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal)
    raise ValueError(f"flash attention: no kernel for device {q.device}")


def _bwd(q, k, v, out, lse, dout, causal, g_lse):
    if q.device.type == "cuda":
        return _bwd_kernels(q, k, v, out, lse,
                            dout.to(q.dtype).contiguous(), causal, g_lse)
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, out, lse, dout, causal, g_lse)
    raise ValueError(f"flash attention: no kernel for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """(out, lse) = FlashAttention.apply(q, k, v, causal). The forward
    saves (q, k, v, out, lse) like the reference's ``_flash_fwd_rule``;
    the backward runs the dQ and dK/dV kernels (or their plain version)
    with the lse cotangent folded into delta."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        check_args(q, k, v)
        if q.device.type == "cuda":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _fwd(q, k, v, causal)
        ctx.causal = bool(causal)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, out, lse)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = _bwd(q, k, v, out, lse, g_out, ctx.causal, g_lse)
        return dq, dk, dv, None


def flash_attention_with_lse(q, k, v, causal=False):
    """Differentiable (out [B, S, H, D], lse [B * H, 1, S] f32): the
    building block of blockwise and ring attention. Kernels on CUDA,
    plain versions on the CPU."""
    return FlashAttention.apply(q, k, v, causal)


def flash_attention(q, k, v, causal=False):
    """Differentiable flash attention in [B, S, H, D] layout; k and v may
    carry fewer (grouped) heads. Kernels on CUDA, plain versions on the
    CPU."""
    return flash_attention_with_lse(q, k, v, causal)[0]


def flash_attention_fwd(q, k, v, causal=False):
    """The reference's entry for ``nn.functional``. The reference sends
    shapes its TPU kernel cannot tile (S % 128 != 0) to XLA; the CUDA
    kernels take any S, so this is :func:`flash_attention`."""
    return flash_attention(q, k, v, causal)
