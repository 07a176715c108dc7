"""Llama family in PyTorch: configuration, the stacked-parameter model,
its training forward and loss, and the serving functions of the paged
decode engine.

Counterpart of ``paddle_tpu/models/llama.py``. Parameters are stacked
over layers (``[L, ...]``) under the reference's keys, so a JAX
``state_dict`` loads as it is (:mod:`paddle_tpu_torch.convert`). The
serving functions keep the reference's names and argument order; where
the reference returns updated KV pools, these update the pools in place
(the reference donates them to its compiled programs for the same
effect) and say so. They run under ``torch.no_grad()`` in the engine.

Training (:meth:`LlamaForCausalLM.forward` without a mask,
:func:`llama_loss_fn`) runs causal attention through the FlashAttention-2
kernels (:mod:`paddle_tpu_torch.kernels.flash_attention`) and, with
``recompute``, rematerializes each layer in the backward as the
reference's ``jax.checkpoint`` policies do (:func:`_scan_layers`).

Tensor parallelism (the reference's ``mp_axis=``): the serving
functions take ``stacked``, the KV pools and their int8 scales either
whole or as lists of per-rank shards (``inference.sharding``). Each
layer then runs every rank's column-parallel projections and attention
on that rank's device and sums the row-parallel products in rank order
(:func:`_tp_layer`); one controller drives all ranks, and one rank is
the unsharded arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import DEFAULT_DEVICE
from ..kernels.flash_attention import flash_attention
from ..kernels.paged_attention import (gather_pages_dequant,
                                       mixed_paged_attention,
                                       paged_decode_attention)
from ..nn.functional.loss import cross_entropy

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LLAMA_PRESETS",
           "llama_loss_fn", "masked_prefill", "scatter_prefill_kv",
           "prefix_prefill", "mixed_paged_step", "mixed_paged_logits"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False
    # Qwen2-style additive QKV biases
    attention_bias: bool = False
    # rematerialize each decoder layer in the backward: "full" recomputes
    # the whole layer, "core_attn" keeps the projections' and the
    # attention's outputs and recomputes the norms, rope, attention and
    # SwiGLU core (see _scan_layers)
    recompute: bool = False
    recompute_granularity: str = "full"
    dtype: str = "float32"
    # mixture of experts (0 experts = dense); the port runs dense models
    # only, the fields exist so that every reference preset parses
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 0
    moe_num_shared_experts: int = 0

    def __post_init__(self):
        if self.recompute_granularity not in ("full", "core_attn"):
            raise ValueError(
                f"unknown recompute_granularity "
                f"{self.recompute_granularity!r}; expected 'full' or "
                f"'core_attn'")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


LLAMA_PRESETS = {
    "llama3-8b": dict(vocab_size=128256, hidden_size=4096,
                      intermediate_size=14336, num_hidden_layers=32,
                      num_attention_heads=32, num_key_value_heads=8,
                      rope_theta=500000.0),
    "llama2-7b": dict(vocab_size=32000, hidden_size=4096,
                      intermediate_size=11008, num_hidden_layers=32,
                      num_attention_heads=32, num_key_value_heads=32,
                      rope_theta=10000.0),
    "tiny": dict(vocab_size=1024, hidden_size=256, intermediate_size=688,
                 num_hidden_layers=4, num_attention_heads=8,
                 num_key_value_heads=4, max_position_embeddings=2048),
    "debug": dict(vocab_size=128, hidden_size=64, intermediate_size=172,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=256),
    "tiny-moe": dict(vocab_size=1024, hidden_size=256, intermediate_size=512,
                     num_hidden_layers=4, num_attention_heads=8,
                     num_key_value_heads=4, num_experts=4,
                     num_experts_per_tok=2, max_position_embeddings=2048),
    "mixtral-8x7b": dict(vocab_size=32000, hidden_size=4096,
                         intermediate_size=14336, num_hidden_layers=32,
                         num_attention_heads=32, num_key_value_heads=8,
                         rope_theta=1000000.0, num_experts=8,
                         num_experts_per_tok=2,
                         moe_intermediate_size=14336,
                         max_position_embeddings=32768),
    "deepseek-moe-16b": dict(vocab_size=102400, hidden_size=2048,
                             intermediate_size=10944,
                             num_hidden_layers=28,
                             num_attention_heads=16,
                             num_key_value_heads=16,
                             rope_theta=10000.0, num_experts=64,
                             num_experts_per_tok=6,
                             moe_intermediate_size=1408,
                             moe_num_shared_experts=2,
                             max_position_embeddings=4096),
    "qwen2-7b": dict(vocab_size=152064, hidden_size=3584,
                     intermediate_size=18944, num_hidden_layers=28,
                     num_attention_heads=28, num_key_value_heads=4,
                     rope_theta=1000000.0, attention_bias=True),
    "qwen2-0.5b": dict(vocab_size=151936, hidden_size=896,
                       intermediate_size=4864, num_hidden_layers=24,
                       num_attention_heads=14, num_key_value_heads=2,
                       rope_theta=1000000.0, attention_bias=True,
                       tie_word_embeddings=True),
    "qwen2-debug": dict(vocab_size=128, hidden_size=64,
                        intermediate_size=172, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2,
                        max_position_embeddings=256, attention_bias=True,
                        tie_word_embeddings=True),
    "ernie-4.5-lite": dict(vocab_size=103424, hidden_size=2560,
                           intermediate_size=12288, num_hidden_layers=28,
                           num_attention_heads=20, num_key_value_heads=4,
                           rope_theta=500000.0, num_experts=64,
                           num_experts_per_tok=6,
                           moe_intermediate_size=1536,
                           moe_num_shared_experts=2),
    "ernie-debug": dict(vocab_size=128, hidden_size=64,
                        intermediate_size=172, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2,
                        max_position_embeddings=256, num_experts=4,
                        num_experts_per_tok=2, moe_intermediate_size=86,
                        moe_num_shared_experts=1),
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _rope_cos_sin(positions, theta, head_dim):
    """cos and sin [b, s, 1, head_dim/2] of the rotary angles at integer
    ``positions`` [b, s], in fp32. Computed once per forward and shared
    by every layer (the reference's ``_rope`` recomputes them inside
    each layer, which XLA folds; eager PyTorch would not)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    angles = positions[:, :, None].float() * freqs          # [b, s, half]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rope(x, rope):
    """Rotary embedding (rotate halves) on [b, s, h, d] with
    ``rope = _rope_cos_sin(...)``, computed in fp32."""
    cos, sin = rope
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rms(x, w, eps):
    """RMS norm with fp32 accumulation and output in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _masked_softmax(s, valid):
    """Softmax over the last axis where ``valid``; rows with no valid
    entry give zeros instead of NaN."""
    s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.where(torch.isfinite(s).any(-1, keepdim=True), p,
                       torch.zeros((), dtype=p.dtype, device=p.device))


def _attention_keymask(q, k, v, key_mask):
    """Causal GQA attention over [b, s, h, d] with a per-row valid-key
    mask ``key_mask`` [b, s] (left-padded serving prefill)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qh = q.transpose(1, 2).reshape(B, Hkv, G, S, D)
    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)
    s = torch.einsum("bngsd,bntd->bngst", qh, kh).float() / (D ** 0.5)
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    valid = causal[None, :, :] & key_mask[:, None, :].bool()
    p = _masked_softmax(s, valid[:, None, None, :, :])
    out = torch.einsum("bngst,bntd->bngsd", p.to(q.dtype), vh)
    return out.reshape(B, H, S, D).transpose(1, 2)


def _qkv(cfg, lp, y, rope):
    """Projections plus rope: q [b, s, h, hd], k and v [b, s, kvh, hd]."""
    hd = cfg.head_dim
    h = lp["wq"].shape[-1] // hd
    kvh = lp["wk"].shape[-1] // hd
    b, s, _ = y.shape
    q = y @ lp["wq"]
    k = y @ lp["wk"]
    v = y @ lp["wv"]
    if "bq" in lp:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = _rope(q.reshape(b, s, h, hd), rope)
    k = _rope(k.reshape(b, s, kvh, hd), rope)
    return q, k, v.reshape(b, s, kvh, hd)


def _ranks(a):
    """A tensor-parallel argument as the list of its per-rank values: a
    list or tuple of shards as it is, one unsharded value as a list of
    one."""
    return list(a) if isinstance(a, (list, tuple)) else [a]


def _like(vals, arg):
    """Per-rank results shaped as ``arg`` was: a list for a list of
    shards, the one value for an unsharded argument."""
    return vals if isinstance(arg, (list, tuple)) else vals[0]


def _rank_sum(parts, device):
    """The ranks' row-parallel partials summed on ``device`` in rank
    order (the reference's psum): the same result for every rank and on
    every run. One partial is returned as it is."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def _mlp(cfg, lp, x):
    """Residual SwiGLU block; ``lp`` is one layer's parameters or a list
    of per-rank shards (column-parallel gate and up, row-parallel
    down)."""
    lps = _ranks(lp)
    y = _rms(x, lps[0]["post_ln"], cfg.rms_norm_eps)
    parts = []
    for w in lps:
        yr = y.to(w["w_gate"].device)
        parts.append((F.silu(yr @ w["w_gate"]) * (yr @ w["w_up"]))
                     @ w["w_down"])
    return x + _rank_sum(parts, x.device)


def _tp_layer(cfg, lps, x, rope, attend):
    """One decoder layer over the ranks of ``lps`` (one layer's
    parameters per rank; a list of one for an unsharded layer). Each
    rank projects the normed input on its own device, and
    ``attend(r, q, k, v)`` gives the attention of its heads (any shape
    of [b, s, h_r * hd] elements, in x's dtype); the wo products and the
    MLP's are summed over the ranks in rank order. x stays on its
    device."""
    b, s, _ = x.shape
    y = _rms(x, lps[0]["input_ln"], cfg.rms_norm_eps)
    parts = []
    for r, lp in enumerate(lps):
        dev = lp["wq"].device
        q, k, v = _qkv(cfg, lp, y.to(dev), tuple(c.to(dev) for c in rope))
        parts.append(attend(r, q, k, v).reshape(b, s, -1) @ lp["wo"])
    x = x + _rank_sum(parts, x.device)
    return _mlp(cfg, lps, x)


def _attention(q, k, v, causal=True):
    """[b, s, h, d] attention of the training path: the FlashAttention-2
    kernels on CUDA, their plain version on the CPU (the reference takes
    its Pallas kernel on the TPU and ``_sdpa_reference`` elsewhere)."""
    return flash_attention(q, k, v, causal)


def _decoder_layer(cfg, lp, x, rope, key_mask=None, attn=_attention):
    """One decoder layer over [b, s, d]; returns (x, k, v) with the
    post-rope K and V for the decode cache. Without ``key_mask`` the
    attention is causal through ``attn`` (the training path); with it,
    over the valid keys of each row only (left-padded serving
    prefill). ``lp`` may be a list of per-rank shards; k and v then
    come back as per-rank lists."""
    kv = []

    def attend(r, q, k, v):
        kv.append((k, v))
        if key_mask is None:
            return attn(q, k, v)
        return _attention_keymask(q, k, v, key_mask.to(q.device))

    x = _tp_layer(cfg, _ranks(lp), x, rope, attend)
    return x, _like([k for k, _ in kv], lp), _like([v for _, v in kv], lp)


class _NormLinears(torch.autograd.Function):
    """``rms(x) @ w_i (+ b_i)`` for each projection i, saving x, the
    norm weight and the w_i but not rms(x): the backward recomputes the
    norm and not the products, whose outputs the "core_attn" policy
    keeps. ``apply(x, ln, eps, n, w_1..w_n[, b_1..b_n])``."""

    @staticmethod
    def forward(ctx, x, ln, eps, n, *params):
        ws, bs = params[:n], params[n:]
        y = _rms(x, ln, eps)
        outs = [y @ w for w in ws]
        if bs:
            outs = [o + b for o, b in zip(outs, bs)]
        ctx.eps, ctx.has_bias = eps, bool(bs)
        ctx.save_for_backward(x, ln, *ws)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        x, ln, *ws = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            lnd = ln.detach().requires_grad_()
            y = _rms(xd, lnd, ctx.eps)
        y2 = y.detach().reshape(-1, y.shape[-1])
        dy, dws = None, []
        for do, w in zip(douts, ws):
            dws.append(y2.T @ do.reshape(-1, do.shape[-1]))
            t = do @ w.T
            dy = t if dy is None else dy + t
        dx, dln = torch.autograd.grad(y, (xd, lnd), dy)
        dbs = [do.reshape(-1, do.shape[-1]).sum(0) for do in douts] \
            if ctx.has_bias else []
        return (dx, dln, None, None, *dws, *dbs)


class _SwiGLUDown(torch.autograd.Function):
    """``(silu(gate) * up) @ w_down``, saving gate, up and w_down but not
    the product silu(gate) * up, which the backward recomputes."""

    @staticmethod
    def forward(ctx, gate, up, w_down):
        ctx.save_for_backward(gate, up, w_down)
        return (F.silu(gate) * up) @ w_down

    @staticmethod
    def backward(ctx, dout):
        gate, up, w_down = ctx.saved_tensors
        with torch.enable_grad():
            g = gate.detach().requires_grad_()
            u = up.detach().requires_grad_()
            h = F.silu(g) * u
        dw = h.detach().reshape(-1, h.shape[-1]).T \
            @ dout.reshape(-1, dout.shape[-1])
        dgate, dup = torch.autograd.grad(h, (g, u), dout @ w_down.T)
        return dgate, dup, dw


def _core_attention(cfg, q, k, v, rope, attn):
    """Rope and causal attention on the flat projections [b, s, h*hd]
    (k, v: [b, s, kvh*hd]) -> [b, s, h*hd]."""
    b, s, _ = q.shape
    hd = cfg.head_dim
    q = _rope(q.reshape(b, s, -1, hd), rope)
    k = _rope(k.reshape(b, s, -1, hd), rope)
    return attn(q, k, v.reshape(b, s, -1, hd)).reshape(b, s, -1)


def _decoder_layer_core_attn(cfg, lp, x, rope, attn=_attention):
    """One causal decoder layer under the "core_attn" recompute, the
    hand-written counterpart of the reference's
    ``save_only_these_names("qkv", "attn_out", "mlp_gate", "mlp_up")``
    (``llama.py:403-406``). Kept for the backward: the layer input, the
    q/k/v projections (pre-rope, "qkv"), the attention output
    ("attn_out"), the gate and up projections ("mlp_gate", "mlp_up"),
    and the residual stream after attention, which the reference
    recomputes (one matmul) and this keeps. Recomputed: both norms,
    rope, the attention forward (its out and lse, so the FA2 forward
    launches twice per layer and step) and silu(gate) * up."""
    eps = cfg.rms_norm_eps
    bias = (lp["bq"], lp["bk"], lp["bv"]) if "bq" in lp else ()
    q, k, v = _NormLinears.apply(x, lp["input_ln"], eps, 3, lp["wq"],
                                 lp["wk"], lp["wv"], *bias)
    a = checkpoint(_core_attention, cfg, q, k, v, rope, attn,
                   use_reentrant=False)
    x = x + a @ lp["wo"]
    gate, up = _NormLinears.apply(x, lp["post_ln"], eps, 2, lp["w_gate"],
                                  lp["w_up"])
    return x + _SwiGLUDown.apply(gate, up, lp["w_down"])


def _decoder_layer_full(cfg, lp, x, rope, attn):
    return _decoder_layer(cfg, lp, x, rope, attn=attn)[0]


def _scan_layers(cfg, stacked, x, rope, attn=_attention):
    """The causal decoder stack over the stacked [L, ...] parameters
    (the reference's ``jax.lax.scan``): a loop over layers. The stacks
    are unbound once, so each one's gradient comes back in one copy.
    With ``cfg.recompute`` each layer is rematerialized in the backward
    (``torch.utils.checkpoint``, non-reentrant): "full" recomputes the
    whole layer, "core_attn" is :func:`_decoder_layer_core_attn`."""
    layers = {n: w.unbind(0) for n, w in stacked.items()}
    for i in range(cfg.num_hidden_layers):
        lp = {n: w[i] for n, w in layers.items()}
        if not cfg.recompute:
            x = _decoder_layer_full(cfg, lp, x, rope, attn)
        elif cfg.recompute_granularity == "full":
            x = checkpoint(_decoder_layer_full, cfg, lp, x, rope, attn,
                           use_reentrant=False)
        else:
            x = _decoder_layer_core_attn(cfg, lp, x, rope, attn)
    return x


def _llama_forward(cfg, stacked, embed, final_norm, lm_head, token_ids,
                   key_mask=None, attn=_attention):
    """Logits [b, s, V] for token ids [b, s]: embedding, the decoder
    stack, the final norm and the head. Without ``key_mask`` the
    attention is causal through ``attn`` and the stack recomputes as
    ``cfg.recompute`` says (:func:`_scan_layers`); ``key_mask`` [b, s]
    (1 = real token, left-padded rows) excludes pad keys instead.
    Positions are plain ``arange`` either way: rope is relative, so only
    the key exclusion carries the padding."""
    b, s = token_ids.shape
    positions = torch.arange(s, device=token_ids.device)[None, :] \
        .expand(b, s)
    rope = _rope_cos_sin(positions, cfg.rope_theta, cfg.head_dim)
    x = F.embedding(token_ids, embed)
    if key_mask is None:
        x = _scan_layers(cfg, stacked, x, rope, attn)
    else:
        for i in range(cfg.num_hidden_layers):
            x = _decoder_layer(cfg, _layer(stacked, i), x, rope,
                               key_mask)[0]
    return _rms(x, final_norm, cfg.rms_norm_eps) @ lm_head


def llama_loss_fn(model, input_ids, labels):
    """Causal LM loss, the reference's: logits[:, :-1] scored against
    labels[:, 1:] with ``ignore_index=-100``, the mean over the labels
    kept. (The reference adds MoE's router penalty; MoE is not ported.)"""
    logits = model(input_ids)
    vocab = logits.shape[-1]
    return cross_entropy(logits[:, :-1].reshape(-1, vocab),
                         labels[:, 1:].reshape(-1), ignore_index=-100)


def _layer(stacked, i):
    return {n: w[i] for n, w in stacked.items()}


class LlamaForCausalLM(nn.Module):
    """Stacked-parameter Llama. ``state_dict`` keys: ``layers.<name>``
    hold the [L, ...] stacks; ``embed_tokens``, ``final_norm`` and
    ``lm_head`` (absent with tied embeddings) the rest.

    Weights are drawn from ``generator`` (default: seed 0 on
    ``device``) as the reference draws them: N(0, 0.02) for matrices,
    ones for norms, zeros for attention biases. On the ``meta`` device
    they are left undrawn, for a checkpoint to fill. They require grad,
    as trainable parameters do; the serving engine runs under
    ``torch.no_grad()`` and builds no graph."""

    def __init__(self, config: LlamaConfig | str = "tiny", *, dtype=None,
                 device=DEFAULT_DEVICE, generator=None):
        super().__init__()
        if isinstance(config, str):
            config = LlamaConfig(**LLAMA_PRESETS[config])
        if config.num_experts > 0:
            raise NotImplementedError(
                "mixture-of-experts Llama is not ported yet (ROADMAP.md "
                "Queue 1, item 8: mixture of experts)")
        self.config = cfg = config
        dtype = _DTYPES[cfg.dtype] if dtype is None else dtype
        if generator is None and torch.device(device).type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        d, L = cfg.hidden_size, cfg.num_hidden_layers
        h, kvh, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        ff = cfg.intermediate_size

        def mk(shape, init="normal"):
            t = torch.empty(shape, dtype=dtype, device=device)
            if t.is_meta:               # shapes only (checkpoint loading)
                pass
            elif init == "ones":
                t.fill_(1.0)
            elif init == "zeros":
                t.zero_()
            else:
                t.normal_(0.0, 0.02, generator=generator)
            return nn.Parameter(t)

        self.embed_tokens = mk((cfg.vocab_size, d))
        layers = {"wq": mk((L, d, h * hd)), "wk": mk((L, d, kvh * hd)),
                  "wv": mk((L, d, kvh * hd)), "wo": mk((L, h * hd, d))}
        if cfg.attention_bias:
            layers.update(bq=mk((L, h * hd), "zeros"),
                          bk=mk((L, kvh * hd), "zeros"),
                          bv=mk((L, kvh * hd), "zeros"))
        layers.update(input_ln=mk((L, d), "ones"),
                      post_ln=mk((L, d), "ones"),
                      w_gate=mk((L, d, ff)), w_up=mk((L, d, ff)),
                      w_down=mk((L, ff, d)))
        self.layers = nn.ParameterDict(layers)
        self.final_norm = mk((d,), "ones")
        if cfg.tie_word_embeddings:
            self.register_parameter("lm_head", None)
        else:
            self.lm_head = mk((d, cfg.vocab_size))

    def weights(self):
        """(stacked, embed, final_norm, lm_head) as the serving functions
        take them; ``lm_head`` is ``embed.T`` with tied embeddings."""
        stacked = dict(self.layers.items())
        head = self.embed_tokens.T if self.lm_head is None else self.lm_head
        return stacked, self.embed_tokens, self.final_norm, head

    def forward(self, input_ids, attention_mask=None):
        """Logits [b, s, V] for token ids [b, s]. Without
        ``attention_mask`` this is the training forward (causal FA2,
        recompute as configured); ``attention_mask`` [b, s] (1 = real
        token) excludes pad keys. Differentiable when the parameters
        require grad."""
        key_mask = None if attention_mask is None \
            else attention_mask.bool()
        return _llama_forward(self.config, *self.weights(), input_ids,
                              key_mask)


def _sample(logits, temperature, top_k, generator=None):
    """Next token per row of ``logits`` [b, V]: argmax when
    ``temperature`` is 0, else a draw from the softmax of
    ``logits / temperature`` restricted to the ``top_k`` largest
    (``top_k`` 0 = all). Draws come from ``generator``."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits.float() / temperature
    if top_k and top_k > 0:
        kth = logits.sort(dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]




def masked_prefill(cfg, stacked, embed, final_norm, lm_head, ids,
                   pad_len, last_index=None):
    """Serving prefill of left-padded ``ids`` [b, s] with per-row
    ``pad_len`` [b] -> (logits [b, V] fp32 at ``last_index`` (default:
    the last column), ks, vs [L, b, s, kvh, hd] post-rope K/V). With
    ``stacked`` a list of per-rank shards, ks and vs are per-rank lists
    of the ranks' kv heads, matching the pools they go into."""
    stacks = _ranks(stacked)
    b, s0 = ids.shape
    cols = torch.arange(s0, device=ids.device)[None, :]
    positions = torch.clamp(cols - pad_len[:, None], min=0)
    rope = _rope_cos_sin(positions, cfg.rope_theta, cfg.head_dim)
    key_mask = cols >= pad_len[:, None]
    x = embed[ids]
    ks, vs = [[] for _ in stacks], [[] for _ in stacks]
    for i in range(cfg.num_hidden_layers):
        x, k, v = _decoder_layer(cfg, [_layer(st, i) for st in stacks], x,
                                 rope, key_mask)
        for r in range(len(stacks)):
            ks[r].append(k[r])
            vs[r].append(v[r])
    x = _rms(x, final_norm, cfg.rms_norm_eps)
    last = x[:, -1] if last_index is None else x[:, last_index]
    return ((last @ lm_head).float(),
            _like([torch.stack(k) for k in ks], stacked),
            _like([torch.stack(v) for v in vs], stacked))


def _quantized_prefill_scatter(pool, scales, toks, page, off, valid,
                               table_row):
    """int8 half of :func:`scatter_prefill_kv` for ONE pool, IN PLACE:
    pool [L, N, bs, kvh, hd] int8 codes, scales [L, N, kvh] f32, toks
    [L, sp, kvh, hd] f32 and page/off/valid [sp]. The scales grow by a
    scatter-max (many tokens land on one page; the order does not
    matter), then every page of ``table_row`` is re-expressed in its
    grown scale by ``round(code * old/new)``. A page whose max did not
    move has ratio exactly 1.0 and keeps its codes bit for bit, which
    is what keeps shared prefix pages intact under a tail prefill: the
    tail never writes into a full shared page. Last, the new tokens are
    quantized against their page's grown scale. Positions with
    ``valid`` False are not written (the reference sends them to the
    NULL page)."""
    toks, page, off = toks[:, valid], page[valid].long(), off[valid].long()
    amax = toks.abs().amax(-1)                               # [L, sp, kvh]
    old_all = scales.clone()
    scales.scatter_reduce_(1, page[None, :, None].expand_as(amax),
                           amax / 127.0, "amax", include_self=True)
    rows = table_row.to(pool.device).long()
    codes = pool[:, rows]                          # [L, mb, bs, kvh, hd]
    ratio = (old_all[:, rows] / scales[:, rows])[:, :, None, :, None]
    pool[:, rows] = torch.clamp(torch.round(codes.float() * ratio),
                                -127, 127).to(pool.dtype)
    qt = torch.clamp(torch.round(toks / scales[:, page][..., None]),
                     -127, 127)
    pool[:, page, off] = qt.to(pool.dtype)


def scatter_prefill_kv(kp, vp, ks, vs, table_row, pad, offset=0,
                       kv_scales=None):
    """Write ONE row's prefill K/V into the pools IN PLACE. kp/vp
    [L, N, bs, kvh, hd]; ks/vs [L, 1, sp, kvh, hd] right-aligned with
    ``pad`` left pads; ``table_row`` [max_blocks]. Token j (j >= pad)
    lands at context position j - pad + ``offset``. With
    ``kv_scales=(kscale, vscale)`` ([L, N, kvh] f32, updated in place)
    the pools hold int8 codes (:func:`_quantized_prefill_scatter`). The
    reference routes pad positions to the NULL page; here they are not
    written at all, which leaves every page other than the NULL page
    identical. Pools, K/V and scales may each be per-rank lists."""
    kps, vps, kss, vss = _ranks(kp), _ranks(vp), _ranks(ks), _ranks(vs)
    bs = kps[0].shape[2]
    sp = kss[0].shape[2]
    pad = int(pad)
    for r, (kpr, vpr) in enumerate(zip(kps, vps)):
        cpos = torch.arange(sp - pad, device=kpr.device) + int(offset)
        page = table_row.to(kpr.device).long()[cpos // bs]
        off = cpos % bs
        if kv_scales is not None:
            valid = torch.ones_like(cpos, dtype=torch.bool)
            for pool, scales, toks in (
                    (kpr, _ranks(kv_scales[0])[r], kss[r]),
                    (vpr, _ranks(kv_scales[1])[r], vss[r])):
                _quantized_prefill_scatter(pool, scales,
                                           toks[:, 0, pad:].float(), page,
                                           off, valid, table_row)
            continue
        kpr[:, page, off] = kss[r][:, 0, pad:].to(kpr.dtype)
        vpr[:, page, off] = vss[r][:, 0, pad:].to(vpr.dtype)


def _decode_slots(tables, lens, bs):
    """Where each row's new token goes: (page, offset) through the block
    table at position ``lens``. The same for every layer of a step."""
    page = tables.gather(1, (lens // bs)[:, None].long())[:, 0].long()
    return page, (lens % bs).long()


def _quantized_token_insert(pool, scales, page, off, tok):
    """Append ONE token per row into an int8 pool page, IN PLACE, with a
    running-max per-(page, kv head) scale. pool [N, bs, kvh, hd] int8
    codes; scales [N, kvh] f32; page/off [b] write cursors; tok
    [b, kvh, hd] f32. The page's scale only grows (``new = max(old,
    amax(tok) / 127)``) and its resident codes are re-expressed in it by
    ``round(code * old/new)``; when the token does not raise the max the
    ratio is exactly 1.0 and the codes stay bit-identical. Inactive and
    mid-prefill rows write the NULL page, as on the fp path."""
    b = tok.shape[0]
    page, off = page.long(), off.long()
    amax = tok.abs().amax(-1)                                 # [b, kvh]
    old = scales[page]
    new = torch.maximum(old, amax / 127.0)
    ratio = (old / new)[:, None, :, None]
    req = torch.clamp(torch.round(pool[page].float() * ratio), -127, 127)
    req[torch.arange(b, device=pool.device), off] = torch.clamp(
        torch.round(tok / new[:, :, None]), -127, 127)
    pool[page] = req.to(pool.dtype)
    scales[page] = new


def _paged_decode_layer_step(cfg, lp, x, kp, vp, tables, lens,
                             kscale=None, vscale=None,
                             attn=paged_decode_attention, rope=None,
                             slots=None):
    """One decoder layer for ONE token per row against the paged cache:
    kp/vp [N, bs, kvh, hd] (this layer's pools, updated IN PLACE),
    tables [b, max_blocks] int32, lens [b] int32 = tokens already cached
    (the new token's position). With ``kscale``/``vscale`` ([N, kvh]
    f32, updated in place) the pools hold int8 codes: the token goes in
    through :func:`_quantized_token_insert` and the attention reads the
    codes with their scales. Inactive rows carry all-NULL tables, so
    their writes land on page 0; on the card those duplicate writes
    race, which is harmless because no active row reads page 0 within
    its length. ``attn`` is the attention function (the kernel wrapper
    by default, or the plain version for comparison); ``rope`` and
    ``slots`` may be passed precomputed (:func:`_paged_decode_step`
    shares them across layers). ``lp``, the pools and the scales may be
    per-rank lists (tensor parallel): each rank writes and attends over
    its kv heads."""
    hd = cfg.head_dim
    b = x.shape[0]
    kps, vps = _ranks(kp), _ranks(vp)
    if rope is None:
        rope = _rope_cos_sin(lens[:, None], cfg.rope_theta, hd)
    page, off = _decode_slots(tables, lens, kps[0].shape[1]) \
        if slots is None else slots

    def attend(r, q, k, v):
        dev = q.device
        pg, of = page.to(dev), off.to(dev)
        tab, n = tables.to(dev), lens.to(dev) + 1
        qg = q[:, 0].reshape(b, k.shape[2], -1, hd).contiguous()
        if kscale is None:
            kps[r][pg, of] = k[:, 0].to(kps[r].dtype)
            vps[r][pg, of] = v[:, 0].to(vps[r].dtype)
            out = attn(qg, kps[r], vps[r], tab, n)
        else:
            ks, vs = _ranks(kscale)[r], _ranks(vscale)[r]
            _quantized_token_insert(kps[r], ks, pg, of, k[:, 0].float())
            _quantized_token_insert(vps[r], vs, pg, of, v[:, 0].float())
            out = attn(qg, kps[r], vps[r], tab, n, kv_scales=(ks, vs))
        return out.to(x.dtype)

    return _tp_layer(cfg, _ranks(lp), x, rope, attend)


def _per_layer(pools, i):
    """Layer ``i`` of a stacked pool or scale, or of each rank's."""
    return None if pools is None else _like([p[i] for p in _ranks(pools)],
                                            pools)


def _paged_decode_step(cfg, stacked, embed, final_norm, lm_head, token,
                       pages_k, pages_v, tables, lens, kscales=None,
                       vscales=None, attn=paged_decode_attention):
    """Paged single-token step: token ids [b], pools [L, N, bs, kvh, hd]
    (updated IN PLACE), tables [b, max_blocks], lens [b] -> logits
    [b, V] fp32. int8 pools pass ``kscales``/``vscales`` [L, N, kvh]
    f32, also updated in place. Weights, pools and scales may be
    per-rank lists (tensor parallel)."""
    stacks = _ranks(stacked)
    x = embed[token][:, None, :]
    rope = _rope_cos_sin(lens[:, None], cfg.rope_theta, cfg.head_dim)
    slots = _decode_slots(tables, lens, _ranks(pages_k)[0].shape[2])
    for i in range(cfg.num_hidden_layers):
        x = _paged_decode_layer_step(
            cfg, [_layer(st, i) for st in stacks], x,
            _per_layer(pages_k, i), _per_layer(pages_v, i), tables, lens,
            _per_layer(kscales, i), _per_layer(vscales, i), attn=attn,
            rope=rope, slots=slots)
    x = _rms(x, final_norm, cfg.rms_norm_eps)
    return (x[:, 0] @ lm_head).float()


def _attention_prefix(q, k, v, key_mask, pk, pv, prefix_mask):
    """Causal window attention over the uncached tail (``key_mask``
    marks its real positions) PLUS the row's cached prefix pk/pv
    [b, sp, kvh, hd] (``prefix_mask`` [b, sp] marks valid positions),
    which every window query sees."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qh = q.transpose(1, 2).reshape(B, Hkv, G, S, D)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    pkh, pvh = pk.transpose(1, 2), pv.transpose(1, 2)
    sw = torch.einsum("bngsd,bntd->bngst", qh, kh).float() / (D ** 0.5)
    sp = torch.einsum("bngsd,bntd->bngst", qh, pkh).float() / (D ** 0.5)
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    valid_w = causal[None, :, :] & key_mask[:, None, :].bool()
    valid_p = prefix_mask[:, None, :].bool().expand(B, S, -1)
    s = torch.cat([sp, sw], dim=-1)          # prefix first: chrono order
    valid = torch.cat([valid_p, valid_w], dim=-1)
    p = _masked_softmax(s, valid[:, None, None, :, :])
    vall = torch.cat([pvh, vh], dim=2)
    out = torch.einsum("bngst,bntd->bngsd", p.to(q.dtype), vall)
    return out.reshape(B, H, S, D).transpose(1, 2)


def _prefix_decoder_layer(cfg, lp, x, rope, key_mask, pk, pv,
                          prefix_mask):
    """One decoder layer over an uncached tail window attending to a
    cached paged prefix; returns (x, k, v) with the tail's K/V. ``lp``,
    pk and pv may be per-rank lists (k and v then are too)."""
    pks, pvs, kv = _ranks(pk), _ranks(pv), []

    def attend(r, q, k, v):
        kv.append((k, v))
        dev = q.device
        return _attention_prefix(q, k, v, key_mask.to(dev), pks[r], pvs[r],
                                 prefix_mask.to(dev))

    x = _tp_layer(cfg, _ranks(lp), x, rope, attend)
    return x, _like([k for k, _ in kv], lp), _like([v for _, v in kv], lp)


def prefix_prefill(cfg, stacked, embed, final_norm, lm_head, ids,
                   pad_len, prefix_len, kp, vp, table_row,
                   last_index=None, kv_scales=None, all_logits=False):
    """Prefill of an uncached TAIL over a prefix already in the pools.

    ``ids`` [1, sc]: tail tokens right-aligned (``pad_len`` [1] left
    pads); ``prefix_len`` [1]: cached tokens reachable through
    ``table_row`` [max_blocks]. Rope positions start at ``prefix_len``;
    each layer gathers its prefix K/V through the table, the tail
    attends over prefix + causal window, and the tail's K/V are
    scattered into kp/vp [L, N, bs, kvh, hd] IN PLACE at
    ``offset=prefix_len``. ``kv_scales`` ([L, N, kvh] f32 pair, updated
    in place) switches the pools to int8 codes: the gathers dequantize
    and the scatter quantizes. Returns the last real position's logits
    [1, V] fp32, or with ``all_logits`` the logits of every window
    position [1, sc, V] (the speculative verify shape). Weights, pools
    and scales may be per-rank lists (tensor parallel)."""
    stacks, kps, vps = _ranks(stacked), _ranks(kp), _ranks(vp)
    b, sc = ids.shape
    bs = kps[0].shape[2]
    mb = table_row.shape[0]
    cols = torch.arange(sc, device=ids.device)[None, :]
    positions = torch.clamp(cols - pad_len[:, None], min=0) \
        + prefix_len[:, None]
    rope = _rope_cos_sin(positions, cfg.rope_theta, cfg.head_dim)
    key_mask = cols >= pad_len[:, None]
    prefix_mask = (torch.arange(mb * bs, device=ids.device)[None, :]
                   < prefix_len[:, None])
    x = embed[ids]
    ks, vs = [[] for _ in stacks], [[] for _ in stacks]
    for i in range(cfg.num_hidden_layers):
        pk, pv = [], []
        for r, (kpr, vpr) in enumerate(zip(kps, vps)):
            rows = table_row.to(kpr.device).long()
            if kv_scales is None:
                pk.append(kpr[i][rows].reshape(1, mb * bs, *kpr.shape[3:]))
                pv.append(vpr[i][rows].reshape(1, mb * bs, *vpr.shape[3:]))
            else:
                pk.append(gather_pages_dequant(
                    kpr[i], rows[None], _ranks(kv_scales[0])[r][i]))
                pv.append(gather_pages_dequant(
                    vpr[i], rows[None], _ranks(kv_scales[1])[r][i]))
        x, k, v = _prefix_decoder_layer(
            cfg, [_layer(st, i) for st in stacks], x, rope, key_mask,
            [t.to(x.dtype) for t in pk], [t.to(x.dtype) for t in pv],
            prefix_mask)
        for r in range(len(stacks)):
            ks[r].append(k[r])
            vs[r].append(v[r])
    x = _rms(x, final_norm, cfg.rms_norm_eps)
    if all_logits:
        logits = (x @ lm_head).float()
    else:
        last = x[:, -1] if last_index is None else x[:, last_index]
        logits = (last @ lm_head).float()
    scatter_prefill_kv(kp, vp, _like([torch.stack(k) for k in ks], kp),
                       _like([torch.stack(v) for v in vs], kp), table_row,
                       int(pad_len[0]), offset=int(prefix_len[0]),
                       kv_scales=kv_scales)
    return logits


# -- the single-launch mixed step ---------------------------------------------

def _quantized_mixed_scatter(pool, scales, toks, page, off, valid, tables):
    """int8 write half of the mixed step for ONE layer's pool, IN PLACE:
    the [B, T] window form of :func:`_quantized_prefill_scatter`. pool
    [N, bs, kvh, hd] int8 codes; scales [N, kvh] f32; toks
    [B, T, kvh, hd] f32; page/off/valid [B, T]; tables [B, mb]. The
    scales grow by a scatter-max, then every page any row's table names
    is re-expressed in its grown scale (ratio exactly 1.0, codes
    bit-identical, for a page whose max did not move, which includes
    every shared prefix page: valid window writes only reach a row's
    private tail pages, so rows sharing a page write it identical
    values). Padding slots (``valid`` False) contribute amax 0 and write
    the NULL page, as the reference's do."""
    kvh = scales.shape[1]
    page, off = page.long(), off.long()
    amax = torch.where(valid[..., None], toks.abs().amax(-1),
                       torch.zeros((), device=toks.device))   # [B, T, kvh]
    old_all = scales.clone()
    flat = page.reshape(-1)
    scales.scatter_reduce_(0, flat[:, None].expand(-1, kvh),
                           (amax / 127.0).reshape(-1, kvh), "amax",
                           include_self=True)
    rows = tables.long()
    codes = pool[rows]                              # [B, mb, bs, kvh, hd]
    ratio = (old_all[rows] / scales[rows])[:, :, None, :, None]
    pool[rows] = torch.clamp(torch.round(codes.float() * ratio),
                             -127, 127).to(pool.dtype)
    qt = torch.clamp(torch.round(toks / scales[page][..., None]), -127, 127)
    pool[page, off] = qt.to(pool.dtype)


def _mixed_decoder_layer(cfg, lp, x, rope, valid, page, off, tables,
                         kv_lens, q_lens, kp, vp, kscale=None, vscale=None,
                         attn=mixed_paged_attention):
    """One decoder layer for a mixed window batch: row b carries
    q_lens[b] window tokens (LEFT-aligned: a prefill chunk, a verify
    window or one decode token) ending at context position
    kv_lens[b] - 1. Scatter-then-attend, the mixed kernel's contract:
    the window's K/V land in kp/vp [N, bs, kvh, hd] (IN PLACE; padding
    slots on the NULL page, whose duplicate writes race on the card and
    are never read within a row's length), then ``attn`` (the kernel
    wrapper by default) reads every position below kv_lens. With
    ``kscale``/``vscale`` the pools hold int8 codes
    (:func:`_quantized_mixed_scatter`). ``lp``, the pools and the scales
    may be per-rank lists (tensor parallel)."""
    hd = cfg.head_dim
    b, t, _ = x.shape
    kps, vps = _ranks(kp), _ranks(vp)

    def attend(r, q, k, v):
        dev = q.device
        pg, of, tab = page.to(dev), off.to(dev), tables.to(dev)
        if kscale is None:
            kps[r][pg, of] = k.to(kps[r].dtype)
            vps[r][pg, of] = v.to(vps[r].dtype)
            scales = None
        else:
            scales = (_ranks(kscale)[r], _ranks(vscale)[r])
            ok = valid.to(dev)
            _quantized_mixed_scatter(kps[r], scales[0], k.float(), pg, of,
                                     ok, tab)
            _quantized_mixed_scatter(vps[r], scales[1], v.float(), pg, of,
                                     ok, tab)
        qg = q.reshape(b, t, k.shape[2], -1, hd).contiguous()
        out = attn(qg, kps[r], vps[r], tab, kv_lens.to(dev),
                   q_lens.to(dev), kv_scales=scales)
        return out.to(x.dtype)

    return _tp_layer(cfg, _ranks(lp), x, rope, attend)


def mixed_paged_step(cfg, stacked, embed, final_norm, lm_head, ids, q_lens,
                     kv_lens, tables, pages_k, pages_v, kscales=None,
                     vscales=None, attn=mixed_paged_attention):
    """The single-launch mixed step: every decode-ready row's window
    (its pending token and drafts) and every funded prefill chunk in
    one pass. ids [B, T] LEFT-aligned windows (slot i >= q_lens[b] is
    padding), kv_lens [B] INCLUDING this launch's windows, tables
    [B, mb], pools [L, N, bs, kvh, hd] (and int8 scales [L, N, kvh])
    updated IN PLACE. Returns the argmax token [B, T] int32 at every
    window slot (of :func:`mixed_paged_logits`): the engine reads chunk
    first tokens, verify chains and decode tokens off the windows.
    Padding slots rope at position 0 and write NULL page 0, offset 0;
    rows with q_lens 0 are idle. Weights, pools and scales may be
    per-rank lists (tensor parallel)."""
    return mixed_paged_logits(
        cfg, stacked, embed, final_norm, lm_head, ids, q_lens, kv_lens,
        tables, pages_k, pages_v, kscales, vscales,
        attn=attn).argmax(dim=-1).to(torch.int32)


def mixed_paged_logits(cfg, stacked, embed, final_norm, lm_head, ids,
                       q_lens, kv_lens, tables, pages_k, pages_v,
                       kscales=None, vscales=None,
                       attn=mixed_paged_attention):
    """:func:`mixed_paged_step`'s pass up to its fp32 logits [B, T, V]."""
    stacks = _ranks(stacked)
    B, T = ids.shape
    bs = _ranks(pages_k)[0].shape[2]
    j = torch.arange(T, device=ids.device)[None, :]
    valid = j < q_lens[:, None]
    zero = torch.zeros((), dtype=torch.long, device=ids.device)
    pos = torch.where(valid, kv_lens[:, None].long() - q_lens[:, None] + j,
                      zero)
    page = torch.where(valid, tables.gather(1, pos // bs).long(), zero)
    off = torch.where(valid, pos % bs, zero)
    rope = _rope_cos_sin(pos, cfg.rope_theta, cfg.head_dim)
    x = embed[ids]
    for i in range(cfg.num_hidden_layers):
        x = _mixed_decoder_layer(
            cfg, [_layer(st, i) for st in stacks], x, rope, valid, page, off,
            tables, kv_lens, q_lens, _per_layer(pages_k, i),
            _per_layer(pages_v, i), _per_layer(kscales, i),
            _per_layer(vscales, i), attn=attn)
    x = _rms(x, final_norm, cfg.rms_norm_eps)
    return (x @ lm_head).float()
