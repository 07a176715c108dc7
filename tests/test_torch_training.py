"""Parity of the port's training slice with the JAX reference.

The same numpy inputs and weights go through both packages: the loss,
one AdamW update (decay mask, amsgrad, fp32 master of bf16 parameters)
and three whole ``TrainStep``s on the ``debug`` and ``qwen2-debug``
presets in fp32, where every step's loss agrees within 1e-5 relative.
On the CPU the port's attention is the plain version of its FA2
kernels and the reference's is ``_sdpa_reference`` (its Pallas kernel
runs only on the TPU); the kernels are checked on the card by
``chip_smoke.py``. Torch, the port and JAX are imported inside
fixtures and tests.
"""

import types

import numpy as np
import pytest

PRESETS = ("debug", "qwen2-debug")
LOSS_RTOL = 1e-5     # fp32 per-step loss, sums in other orders
# parameters after 3 AdamW steps at lr 1e-3: Adam divides m by sqrt(v),
# so where a gradient is near zero its last-digit noise moves the
# update by a visible part of lr (measured: up to 1.7e-5, in the
# qwen2 key bias, whose gradient is about 3e-5); 5e-5 is 5% of one step
PARAM_ATOL = 5e-5
# moments: relative to the largest entry of each slot (measured <= 4e-5)
MOMENT_RTOL = 1e-4


def _batches(vocab, n=3, b=2, s=24, seed=0):
    """bench.py's data: a noisy affine next-token process over at most
    256 ids, from a seeded numpy generator. The last batch carries a few
    ignored labels (-100)."""
    rng = np.random.default_rng(seed)
    support = min(256, vocab)
    out = []
    for i in range(n):
        toks = np.empty((b, s), np.int64)
        toks[:, 0] = rng.integers(0, support, b)
        noise = rng.integers(-2, 3, size=(b, s - 1))
        for t in range(1, s):
            toks[:, t] = (toks[:, t - 1] * 5 + 17 + noise[:, t - 1]) \
                % support
        labels = toks.copy()
        if i == n - 1:
            labels[:, 5:9] = -100
        out.append((toks, labels))
    return out


@pytest.fixture(scope="module", params=PRESETS)
def trained(request):
    """Three fp32 TrainSteps of the JAX model and of the port on the same
    weights and batches: per-step losses and the final states."""
    import torch
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM
    from paddle_tpu.models.llama import llama_loss_fn as jax_loss
    from paddle_tpu_torch.convert import from_jax_state_dict
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import llama_loss_fn
    from paddle_tpu_torch.optimizer import AdamW
    preset = request.param
    paddle.seed(0)
    jm = LlamaForCausalLM(preset)
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    if jm.config.attention_bias:
        rng = np.random.RandomState(5)
        for name in ("bq", "bk", "bv"):
            state[name] = (rng.randn(*state[name].shape) * 0.1).astype(
                np.float32)
        jm.set_state_dict(state)
    pm = from_jax_state_dict(state, preset, device="cpu", trainable=True)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    popt = AdamW(learning_rate=1e-3, parameters=pm.named_parameters())
    jstep = paddle.jit.TrainStep(jm, jopt, jax_loss)
    pstep = TrainStep(pm, popt, llama_loss_fn)
    losses = []
    for ids, labels in _batches(jm.config.vocab_size):
        lj = float(jstep(paddle.to_tensor(ids.astype(np.int32)),
                         paddle.to_tensor(labels.astype(np.int32))))
        lp = float(pstep(torch.from_numpy(ids), torch.from_numpy(labels)))
        losses.append((lj, lp))
    return types.SimpleNamespace(jm=jm, pm=pm, jopt=jopt, popt=popt,
                                 losses=losses, torch=torch)


def test_train_step_losses_match_jax(trained):
    for step, (lj, lp) in enumerate(trained.losses):
        assert np.isfinite(lp)
        assert abs(lp - lj) <= LOSS_RTOL * abs(lj), (step, lj, lp)
    # the optimizer moved the model: the losses are not all one value
    assert len({round(lp, 6) for _, lp in trained.losses}) > 1


def test_train_step_state_matches_jax(trained):
    """Parameters, both moments and the step count after 3 steps."""
    jparams = {n: (i, p) for i, (n, p) in
               enumerate(trained.jm.named_parameters())}
    pparams = list(trained.pm.named_parameters())
    assert sorted(n.split(".")[-1] for n, _ in pparams) == sorted(jparams)
    assert trained.popt._global_step == trained.jopt._global_step == 3
    jacc, pacc = trained.jopt._accumulators, trained.popt._accumulators
    assert set(pacc) == set(jacc) == {"moment1", "moment2"}
    for i, (name, p) in enumerate(pparams):
        j, jp = jparams[name.split(".")[-1]]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp._value),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
        for slot in ("moment1", "moment2"):
            want = np.asarray(jacc[slot][j])
            np.testing.assert_allclose(
                pacc[slot][i].numpy(), want, rtol=0,
                atol=MOMENT_RTOL * np.abs(want).max(),
                err_msg=f"{name} {slot}")
        assert p.grad is None


def test_cross_entropy_matches_jax():
    import jax.numpy as jnp
    import torch
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    from paddle_tpu_torch.nn.functional import cross_entropy
    rng = np.random.RandomState(0)
    logits = (rng.randn(12, 11) * 3).astype(np.float32)
    labels = rng.randint(0, 11, (12,)).astype(np.int64)
    labels[[1, 4, 5]] = -100
    for reduction in ("mean", "sum", "none"):
        want = np.asarray(JF.cross_entropy(
            paddle.to_tensor(logits), paddle.to_tensor(labels),
            ignore_index=-100, reduction=reduction)._value)
        got = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels), ignore_index=-100,
                            reduction=reduction)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # bf16 logits go up to f32; every label ignored gives 0, not NaN
    want = np.asarray(JF.cross_entropy(
        paddle.to_tensor(jnp.asarray(logits, jnp.bfloat16)),
        paddle.to_tensor(labels))._value)
    got = cross_entropy(torch.from_numpy(logits).bfloat16(),
                        torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    none = cross_entropy(torch.from_numpy(logits),
                         torch.full((12,), -100, dtype=torch.long))
    assert float(none) == 0.0
    with pytest.raises(NotImplementedError):
        cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                      label_smoothing=0.1)


@pytest.mark.parametrize("opt,amsgrad,multi_precision",
                         [("AdamW", False, False), ("AdamW", True, False),
                          ("AdamW", False, True), ("Adam", False, False)])
def test_adam_update_matches_jax(opt, amsgrad, multi_precision):
    """Two steps on two parameters: AdamW with one of them excluded from
    decay by name, and Adam's L2 decay on the gradient. Parameters,
    moments, amsgrad's max and the fp32 master within 1e-6 (bf16
    parameters with ``multi_precision``, equal to 1e-2, one bf16 ulp at
    their size); then ``state_dict`` carries the state to a fresh
    optimizer."""
    import jax.numpy as jnp
    import torch
    import paddle_tpu.optimizer as jopt_mod
    import paddle_tpu_torch.optimizer as topt_mod
    from paddle_tpu.core.tensor import Parameter, Tensor
    rng = np.random.RandomState(1)
    names = ("w_keep", "b_nodecay")
    vals = [rng.randn(5, 7).astype(np.float32), rng.randn(7).astype(
        np.float32)]
    grads = [[rng.randn(*v.shape).astype(np.float32) for v in vals]
             for _ in range(2)]
    jdt = jnp.bfloat16 if multi_precision else jnp.float32
    tdt = torch.bfloat16 if multi_precision else torch.float32
    jps = [Parameter(jnp.asarray(v, jdt), name=n)
           for n, v in zip(names, vals)]
    tps = [torch.nn.Parameter(torch.from_numpy(v).to(tdt)) for v in vals]
    kw = dict(learning_rate=1e-2, weight_decay=0.1, amsgrad=amsgrad,
              multi_precision=multi_precision)
    if opt == "AdamW":
        kw["apply_decay_param_fun"] = lambda n: not n.startswith("b_")
    jopt = getattr(jopt_mod, opt)(parameters=jps, **kw)
    topt = getattr(topt_mod, opt)(parameters=list(zip(names, tps)), **kw)
    if opt == "AdamW":
        assert topt._decay_mask == [True, False]
    for gs in grads:
        for jp, tp, g in zip(jps, tps, gs):
            jp.grad = Tensor(jnp.asarray(g, jdt))
            tp.grad = torch.from_numpy(g).to(tdt)
        jopt.step()
        topt.step()
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        np.testing.assert_allclose(
            tp.detach().float().numpy(),
            np.asarray(jp._value, np.float32), rtol=0,
            atol=1e-6 if not multi_precision else 1e-2)
        for slot, arrs in jopt._accumulators.items():
            np.testing.assert_allclose(
                topt._accumulators[slot][i].numpy(), np.asarray(arrs[i]),
                rtol=1e-6, atol=1e-6, err_msg=slot)
    assert set(topt._accumulators) == set(jopt._accumulators)
    assert topt._global_step == jopt._global_step == 2
    fresh = getattr(topt_mod, opt)(parameters=list(zip(names, tps)), **kw)
    fresh.set_state_dict(topt.state_dict())
    assert fresh._global_step == 2
    for slot, arrs in topt._accumulators.items():
        for a, b in zip(arrs, fresh._accumulators[slot]):
            assert torch.equal(a, b) and a is not b


def test_recompute_gives_the_same_loss_and_grads():
    """recompute "full" and "core_attn" against none, on the port alone:
    one loss and the same gradients (fp32; the rematerialized forward
    is the same arithmetic)."""
    import dataclasses
    import torch
    from paddle_tpu_torch.models.llama import (LLAMA_PRESETS, LlamaConfig,
                                               LlamaForCausalLM,
                                               llama_loss_fn)
    ids, labels = (torch.from_numpy(a) for a in _batches(128, n=1)[0])
    base = LlamaConfig(**LLAMA_PRESETS["qwen2-debug"])
    runs = {}
    for mode in (None, "full", "core_attn"):
        cfg = dataclasses.replace(base, recompute=mode is not None,
                                  recompute_granularity=mode or "full")
        model = LlamaForCausalLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            for name in ("bq", "bk", "bv"):
                model.layers[name].normal_(0.0, 0.1, generator=torch
                                           .Generator().manual_seed(4))
        loss = llama_loss_fn(model, ids, labels)
        loss.backward()
        runs[mode] = (float(loss.detach()), {n: p.grad.clone()
                                    for n, p in model.named_parameters()})
    loss0, grads0 = runs[None]
    for mode in ("full", "core_attn"):
        loss, grads = runs[mode]
        assert loss == pytest.approx(loss0, rel=1e-6), mode
        for n, g in grads.items():
            torch.testing.assert_close(g, grads0[n], rtol=1e-5, atol=1e-6,
                                       msg=f"{mode} {n}")
    with pytest.raises(ValueError):
        LlamaConfig(recompute=True, recompute_granularity="attn")


def test_serving_builds_no_graph():
    """A trainable model serves without building an autograd graph: the
    pools and logits come out with no grad_fn and the parameters gain
    no gradient; the tokens equal those of the same weights frozen."""
    import torch
    from paddle_tpu_torch.convert import from_jax_state_dict
    from paddle_tpu_torch.inference.serving import DecodeEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    frozen = LlamaForCausalLM("debug", device="cpu",
                              generator=torch.Generator().manual_seed(0))
    state = {k: v.detach().numpy() for k, v in frozen.state_dict().items()}
    live = from_jax_state_dict(state, "debug", device="cpu",
                               trainable=True)
    assert all(p.requires_grad for p in live.parameters())
    prompt = np.random.RandomState(0).randint(1, 128, (9,)).astype(np.int32)
    outs = []
    for model in (frozen.requires_grad_(False), live):
        eng = DecodeEngine(model, capacity=2, s_max=32, chunk=4,
                           block_size=8)
        req = eng.submit(prompt, 6)
        for _ in range(20):
            eng.admit([])
            eng.decode_once()
            if eng.idle():
                break
        outs.append(req.wait(timeout=1))
        assert eng._kp.grad_fn is None and not eng._kp.requires_grad
    np.testing.assert_array_equal(outs[0], outs[1])
    assert all(p.grad is None for p in live.parameters())
