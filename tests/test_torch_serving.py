"""Parity of the port's paged serving slice with the JAX reference.

The same weights (a seeded JAX ``LlamaForCausalLM`` exported as numpy
through ``from_jax_state_dict``) and the same numpy inputs go through
both packages: prefill, scatter, the paged decode step and the
prefix-hit prefill agree in fp32 within 1e-5, and the port's
``DecodeEngine`` emits exactly the JAX engine's greedy tokens on the
``debug`` and ``qwen2-debug`` presets. On the CPU the port's decode
attention is its plain version; the CUDA kernel is checked on the card
by ``chip_smoke.py``.

Each JAX reference (model, engine run) is built once per module and
preset; torch and the port are imported inside fixtures.
"""

import subprocess
import sys
import types

import numpy as np
import pytest

PRESETS = ("debug", "qwen2-debug")
TOL = 1e-5          # fp32, sums in other orders


def _workload():
    """The reference's paged-engine workload, plus a pair sharing a
    20-token prefix (2 full pages of 8 and a partial one), the second
    arriving after the first has retired so that it hits the cache."""
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 128, (n,)).astype(np.int32)
               for n in (8, 10, 5, 6, 7, 5, 6, 4)]
    max_news = [16, 16, 4, 4, 4, 4, 4, 4]
    shared = rng.randint(1, 128, (20,)).astype(np.int32)
    first = np.concatenate([shared, rng.randint(1, 128, (3,))])
    second = np.concatenate([shared, rng.randint(1, 128, (5,))])
    return [(list(zip(prompts, max_news)) + [(first.astype(np.int32), 6)]),
            [(second.astype(np.int32), 6)]]


def _drive(eng, make_request, waves, iters=200):
    """Run each wave to completion in turn; returns every result."""
    reqs = []
    for wave in waves:
        pending = [make_request(p, mn) for p, mn in wave]
        reqs += pending
        for _ in range(iters):
            eng.admit(pending)
            eng.decode_once()
            if eng.idle() and not pending:
                break
        else:
            raise AssertionError("engine did not drain the workload")
    return [r.wait(timeout=1) for r in reqs]


ENGINE = dict(capacity=4, s_max=96, chunk=4, block_size=8)


@pytest.fixture(scope="module", params=PRESETS)
def ref(request):
    """JAX model, its numpy state and the port's model on that state."""
    import torch
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.convert import from_jax_state_dict
    preset = request.param
    paddle.seed(0)
    jm = LlamaForCausalLM(preset)
    jm.eval()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    if jm.config.attention_bias:
        # the reference initialises biases to zero: give them values so
        # that they are exercised
        rng = np.random.RandomState(5)
        for name in ("bq", "bk", "bv"):
            state[name] = (rng.randn(*state[name].shape) * 0.1).astype(
                np.float32)
        jm.set_state_dict(state)
    pm = from_jax_state_dict(state, preset, device="cpu")
    return types.SimpleNamespace(preset=preset, jm=jm, pm=pm, state=state,
                                 cfg=jm.config, torch=torch)


@pytest.fixture(scope="module")
def jax_engine(ref):
    """The JAX engine's outputs and stats on the workload."""
    from paddle_tpu.inference.serving import DecodeEngine, _Request
    eng = DecodeEngine(ref.jm, **ENGINE)
    return _drive(eng, _Request, _workload()), eng.stats()


def _jax_weights(jm):
    p = jm._parameters
    stacked = {n: p[n]._value for n in jm._stacked_names()}
    embed = p["embed_tokens"]._value
    head = p["lm_head"]._value if p.get("lm_head") is not None else embed.T
    return stacked, embed, p["final_norm"]._value, head


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if hasattr(got, "detach") else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def _pools(ref, n_blocks=12, bs=8, seed=3):
    """Random fp32 KV pools [L, N, bs, kvh, hd] in numpy."""
    cfg = ref.cfg
    rng = np.random.RandomState(seed)
    shape = (cfg.num_hidden_layers, n_blocks, bs,
             cfg.num_key_value_heads, cfg.head_dim)
    return (rng.randn(*shape).astype(np.float32) * 0.5,
            rng.randn(*shape).astype(np.float32) * 0.5)


def test_import_leaves_jax_out():
    """The port, all of its slices imported (serving and training),
    loads neither JAX nor the JAX package."""
    code = ("import sys, paddle_tpu_torch;"
            "assert 'torch' not in sys.modules;"
            "import paddle_tpu_torch.inference.serving,"
            " paddle_tpu_torch.inference.spec_decode,"
            " paddle_tpu_torch.inference.sharding,"
            " paddle_tpu_torch.kernels.paged_attention,"
            " paddle_tpu_torch.kernels.flash_attention,"
            " paddle_tpu_torch.models.llama,"
            " paddle_tpu_torch.nn.functional,"
            " paddle_tpu_torch.optimizer,"
            " paddle_tpu_torch.jit,"
            " paddle_tpu_torch.convert;"
            "bad = [m for m in sys.modules if m == 'jax' or"
            " m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu'];"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_state_dict_keys_and_conversion(ref):
    torch = ref.torch
    keys = set(ref.pm.state_dict())
    assert {"embed_tokens", "final_norm", "layers.wq",
            "layers.w_down"} <= keys
    assert ("lm_head" in keys) == (not ref.cfg.tie_word_embeddings)
    assert ("layers.bq" in keys) == ref.cfg.attention_bias
    np.testing.assert_array_equal(ref.pm.layers["wq"].numpy(),
                                  ref.state["wq"])
    from paddle_tpu_torch.convert import from_jax_state_dict
    half = from_jax_state_dict(ref.state, ref.preset, device="cpu",
                               dtype=torch.bfloat16)
    assert half.embed_tokens.dtype == torch.bfloat16
    missing = dict(ref.state)
    missing.pop("wq")
    with pytest.raises(KeyError):
        from_jax_state_dict(missing, ref.preset, device="cpu")


def test_forward_logits_match(ref):
    torch = ref.torch
    ids = np.random.RandomState(2).randint(1, 128, (2, 9)).astype(np.int32)
    want = ref.jm(ids)._value
    _close(ref.pm(torch.from_numpy(ids).long()), want)


def test_masked_prefill_matches(ref):
    import jax.numpy as jnp
    from paddle_tpu.models import llama as jl
    from paddle_tpu_torch.models import llama as tl
    torch = ref.torch
    rng = np.random.RandomState(4)
    ids = rng.randint(1, 128, (2, 12)).astype(np.int32)
    pad = np.asarray([3, 0], np.int32)
    ids[0, :3] = 0
    want = jl.masked_prefill(ref.cfg, *_jax_weights(ref.jm),
                             jnp.asarray(ids), jnp.asarray(pad))
    got = tl.masked_prefill(ref.pm.config, *ref.pm.weights(),
                            torch.from_numpy(ids).long(),
                            torch.from_numpy(pad).long())
    for g, w in zip(got, want):
        _close(g, w)


def test_scatter_and_paged_decode_step_match(ref):
    """Scatter two prompts into the pools, then one paged step over two
    live rows and one inactive all-NULL row."""
    import jax.numpy as jnp
    from paddle_tpu.models import llama as jl
    from paddle_tpu_torch.models import llama as tl
    torch = ref.torch
    kp, vp = _pools(ref)
    rng = np.random.RandomState(6)
    L, bs = kp.shape[0], kp.shape[2]
    jkp, jvp = jnp.asarray(kp), jnp.asarray(vp)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tables = np.asarray([[3, 7, 0, 0], [5, 0, 0, 0], [0, 0, 0, 0]],
                        np.int32)
    lens = np.asarray([11, 8, 0], np.int32)
    for row, n in ((0, 11), (1, 8)):
        sp = 12
        ks = rng.randn(L, 1, sp, *kp.shape[3:]).astype(np.float32)
        vs = rng.randn(L, 1, sp, *kp.shape[3:]).astype(np.float32)
        jkp, jvp = jl.scatter_prefill_kv(jkp, jvp, jnp.asarray(ks),
                                         jnp.asarray(vs),
                                         jnp.asarray(tables[row]), sp - n)
        tl.scatter_prefill_kv(tkp, tvp, torch.from_numpy(ks),
                              torch.from_numpy(vs),
                              torch.from_numpy(tables[row]), sp - n)
    # page 0 takes the reference's pad writes; nothing reads it
    _close(tkp[:, 1:], np.asarray(jkp)[:, 1:], tol=0)
    _close(tvp[:, 1:], np.asarray(jvp)[:, 1:], tol=0)
    tok = np.asarray([17, 42, 0], np.int32)
    want, wkp, wvp = jl._paged_decode_step(
        ref.cfg, *_jax_weights(ref.jm), jnp.asarray(tok), jkp, jvp,
        jnp.asarray(tables), jnp.asarray(lens))
    got = tl._paged_decode_step(
        ref.pm.config, *ref.pm.weights(), torch.from_numpy(tok).long(),
        tkp, tvp, torch.from_numpy(tables), torch.from_numpy(lens))
    _close(got[:2], np.asarray(want)[:2])
    _close(tkp[:, 1:], np.asarray(wkp)[:, 1:])
    _close(tvp[:, 1:], np.asarray(wvp)[:, 1:])


def test_prefix_prefill_matches(ref):
    """A 5-token tail over an 11-token cached prefix (mid-page), in a
    16-slot window, through a table whose tail is NULL."""
    import jax.numpy as jnp
    from paddle_tpu.models import llama as jl
    from paddle_tpu_torch.models import llama as tl
    torch = ref.torch
    kp, vp = _pools(ref, seed=8)
    table = np.asarray([4, 9, 2, 0, 0], np.int32)
    ids = np.zeros((1, 16), np.int32)
    ids[0, 11:] = np.random.RandomState(9).randint(1, 128, 5)
    pad, plen = np.asarray([11], np.int32), np.asarray([11], np.int32)
    want, wkp, wvp = jl.prefix_prefill(
        ref.cfg, *_jax_weights(ref.jm), jnp.asarray(ids),
        jnp.asarray(pad), jnp.asarray(plen), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(table))
    tkp, tvp = torch.from_numpy(kp), torch.from_numpy(vp)
    got = tl.prefix_prefill(
        ref.pm.config, *ref.pm.weights(), torch.from_numpy(ids).long(),
        torch.from_numpy(pad).long(), torch.from_numpy(plen).long(), tkp,
        tvp, torch.from_numpy(table))
    _close(got, want)
    _close(tkp[:, 1:], np.asarray(wkp)[:, 1:])
    _close(tvp[:, 1:], np.asarray(wvp)[:, 1:])


def test_engine_greedy_tokens_match_jax_engine(ref, jax_engine):
    from paddle_tpu_torch.inference.serving import DecodeEngine, _Request
    eng = DecodeEngine(ref.pm, **ENGINE)
    outs = _drive(eng, _Request, _workload())
    want_outs, w = jax_engine
    for got, want in zip(outs, want_outs):
        np.testing.assert_array_equal(got, want)
    s = eng.stats()
    assert s["prefix_hit_tokens"] == w["prefix_hit_tokens"] == 20
    for key in ("admitted", "retired", "failed", "preempted",
                "device_steps", "device_calls", "prefills", "pool"):
        assert s[key] == w[key], key
    assert s["resets"] == 1
    # the prefix cache switched off changes no token
    cold = DecodeEngine(ref.pm, prefix_cache=False, **ENGINE)
    for got, want in zip(_drive(cold, _Request, _workload()), want_outs):
        np.testing.assert_array_equal(got, want)
    assert cold.stats()["prefix_hit_tokens"] == 0


def test_preemption_and_small_pool_keep_outputs(ref):
    """A pool too small for the rows' growth, and a high-priority late
    arrival: rows are preempted and resumed, yet every request gets the
    tokens an ample engine gives it."""
    from paddle_tpu_torch.inference.serving import DecodeEngine
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 128, (6,)).astype(np.int32)
               for _ in range(4)]
    ample = DecodeEngine(ref.pm, capacity=4, s_max=32, chunk=4,
                         block_size=8)
    want = _drive(ample, lambda p, mn: ample.submit(p, mn),
                  [[(p, 10) for p in prompts]])
    # 4 usable pages of 8: three 6-token rows fit at admission, and each
    # needs a second page within the first chunk
    small = DecodeEngine(ref.pm, capacity=3, s_max=32, chunk=4,
                         block_size=8, n_blocks=5)
    low = [small.submit(p, 10) for p in prompts[:3]]
    small.admit([])
    small.decode_once()
    high = small.submit(prompts[3], 10, priority=1)
    for _ in range(50):
        small.admit([])
        small.decode_once()
        if small.idle():
            break
    got = [r.wait(timeout=1) for r in low + [high]]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    st = small.stats()
    assert st["preempted"] >= 2 and st["failed"] == 0, st
    assert small._alloc.conservation_ok


def test_engine_refuses_what_is_not_ported(ref):
    from paddle_tpu_torch.inference.serving import DecodeEngine
    from paddle_tpu_torch.inference.sharding import make_mesh, make_tp_mesh
    seq2 = make_mesh(1, seq_degree=2, devices=["cpu", "cpu"])
    for kw, item in ((dict(paged=False), "item 2"),
                     (dict(mesh=seq2), "item 4")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
            DecodeEngine(ref.pm, **kw)
    for kw in (dict(chunked_prefill=True), dict(spec_decode=True),
               dict(kv_dtype="int8"), dict(chunked_prefill=True,
                                           spec_decode=True,
                                           kv_dtype="int8"),
               dict(mesh=make_tp_mesh(1, devices=["cpu"]))):
        DecodeEngine(ref.pm, **kw)          # ported: these construct
    eng = DecodeEngine(ref.pm, capacity=1, s_max=16, chunk=4)
    with pytest.raises(ValueError):
        eng.submit(np.zeros(0, np.int32))
    too_long = eng.submit(np.ones(14, np.int32), 2)
    eng.admit([])
    with pytest.raises(ValueError, match="s_max"):
        too_long.wait(timeout=1)


def test_sample_greedy_and_top_k(ref):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models.llama import _sample as jsample
    from paddle_tpu_torch.models.llama import _sample
    torch = ref.torch
    logits = np.random.RandomState(11).randn(4, 128).astype(np.float32)
    _, want = jsample(jnp.asarray(logits), 0.0, 0, jax.random.PRNGKey(0))
    got = _sample(torch.from_numpy(logits), 0.0, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    top = np.argsort(logits, axis=-1)[:, -3:]
    g1 = torch.Generator().manual_seed(7)
    draws = torch.stack([_sample(torch.from_numpy(logits), 1.0, 3,
                                 generator=g1) for _ in range(20)], 1)
    assert all(set(d.tolist()) <= set(t.tolist())
               for d, t in zip(draws, top))
    g2 = torch.Generator().manual_seed(7)
    again = torch.stack([_sample(torch.from_numpy(logits), 1.0, 3,
                                 generator=g2) for _ in range(20)], 1)
    assert torch.equal(draws, again)
