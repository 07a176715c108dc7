"""The port's mixed prefill-chunk + decode launch and its tensor-parallel
mesh engine against the JAX reference.

- ``mixed_attn_reference`` (the plain version of ``csrc/mixed_paged.cu``)
  against the reference's Pallas kernel in interpret mode on one
  interleaved case with an idle row, and against ``_mixed_attn_reference``
  at a chunk at offset 0, a final partial chunk, decode-only rows and
  int8 pools: valid query slots within 2e-5 (the kernels multiply by
  1/sqrt(hd) where the references divide, and sum in other orders).
- ``mixed_paged_step`` with fp and int8 pools on ``debug`` and
  ``qwen2-debug`` in fp32, unsharded and split over two CPU ranks,
  against the jitted JAX step: identical argmax tokens, and pools equal
  on every page but the NULL page (int8 codes and scales bit for bit,
  fp32 K/V within 1e-5: the projections sum in other orders).
- The mesh engine on ``debug`` with prefix cache, chunked prefill,
  speculative decoding and int8 KV, the reference's own oracle: the
  port at tp=2 over two CPU ranks against the JAX engine at tp=2, equal
  in tokens and step accounting, and against the port at tp=1 and
  without a mesh. ``tiny`` at tp=4 (one kv head per rank): tokens.
- The engine's mesh errors, the wrapper's CPU dispatch, argument checks
  and C interface. The CUDA kernel itself runs on the card only, in
  ``chip_smoke.py``.

Each JAX reference is built once per module; torch, the port and JAX
are imported inside fixtures.
"""

import re
import types

import numpy as np
import pytest

TOL = 2e-5


@pytest.fixture(scope="module")
def m():
    import jax
    import jax.numpy as jnp
    import torch
    from paddle_tpu.kernels import paged_attention as jpa
    from paddle_tpu.models import llama as jl
    from paddle_tpu_torch.inference import serving, sharding
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models import llama as tl
    return types.SimpleNamespace(jax=jax, jnp=jnp, torch=torch, jpa=jpa,
                                 jl=jl, pa=pa, tl=tl, serving=serving,
                                 sharding=sharding)


def _t(m, *arrays):
    return [m.torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(m, *arrays):
    return [m.jnp.asarray(a) for a in arrays]


def _mixed_case(seed, T, kv_lens, q_lens, kvh=2, G=2, hd=16, bs=8,
                max_blocks=4, int8=False):
    """A pool, tables and windows for one mixed launch; rows own disjoint
    pages, table entries past a row's pages are the NULL page."""
    rng = np.random.RandomState(seed)
    B = len(kv_lens)
    n_blocks = 1 + B * max_blocks
    q = rng.randn(B, T, kvh, G, hd).astype(np.float32) * 0.5
    shape = (n_blocks, bs, kvh, hd)
    if int8:
        kp, vp = (rng.randint(-127, 128, shape).astype(np.int8)
                  for _ in range(2))
    else:
        kp, vp = (rng.randn(*shape).astype(np.float32) * 0.5
                  for _ in range(2))
    table = np.zeros((B, max_blocks), np.int32)
    free = list(rng.permutation(np.arange(1, n_blocks)))
    for b, n in enumerate(kv_lens):
        for j in range(-(-n // bs)):
            table[b, j] = free.pop()
    arrays = [q, kp, vp, table, np.asarray(kv_lens, np.int32),
              np.asarray(q_lens, np.int32)]
    if int8:
        arrays += [((rng.rand(n_blocks, kvh) + 0.5) / 127).astype(np.float32)
                   for _ in range(2)]
    return arrays


def _valid_close(got, want, q_lens):
    for b, n in enumerate(q_lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=0, atol=TOL)


def test_reference_matches_interpret_kernel(m):
    """Decode rows beside chunk rows, and an idle row (kv_len 0) that is
    exact zeros in both."""
    arrays = _mixed_case(seed=27, T=8, kv_lens=(21, 0, 30, 12),
                         q_lens=(1, 0, 8, 5))
    want = np.asarray(m.jpa.mixed_attention_pallas(*_j(m, *arrays),
                                                   interpret=True))
    got = m.pa.mixed_attn_reference(*_t(m, *arrays)).numpy()
    _valid_close(got, want, arrays[5])
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_array_equal(want[1], 0.0)


@pytest.mark.parametrize("case", ["offset0", "final_partial", "decode_only",
                                  "int8"])
def test_reference_matches_jax_reference(m, case):
    kv, ql, T = {"offset0": ((16, 29, 8, 30), (16, 16, 8, 14), 16),
                 "final_partial": ((27, 21, 5, 30), (5, 3, 5, 2), 16),
                 "decode_only": ((27, 5, 32, 16), (1, 1, 1, 1), 16),
                 "int8": ((27, 0, 32, 13), (4, 0, 16, 1), 16)}[case]
    arrays = _mixed_case(seed=len(case), T=T, kv_lens=kv, q_lens=ql,
                         int8=case == "int8")
    if case == "int8":
        base, scales = arrays[:6], arrays[6:]
        want = m.jpa._mixed_attn_reference(*_j(m, *base),
                                           kv_scales=_j(m, *scales))
        got = m.pa.mixed_attn_reference(*_t(m, *base),
                                        kv_scales=_t(m, *scales))
        # the wrapper sends int8 pools down the same gather path
        assert m.torch.equal(got, m.pa.mixed_paged_attention(
            *_t(m, *base), kv_scales=_t(m, *scales)))
    else:
        want = m.jpa._mixed_attn_reference(*_j(m, *arrays))
        got = m.pa.mixed_attn_reference(*_t(m, *arrays))
    _valid_close(got.numpy(), np.asarray(want), ql)
    if case == "decode_only":
        q, kp, vp, table, lens, _ = _t(m, *arrays)
        dec = m.pa.paged_attn_reference(q[:, 0].contiguous(), kp, vp, table,
                                        lens)
        np.testing.assert_allclose(got[:, 0].numpy(), dec.numpy(), rtol=0,
                                   atol=TOL)


# -- the mixed step against the reference ------------------------------------

@pytest.fixture(scope="module", params=["debug", "qwen2-debug"])
def ref(request, m):
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.convert import from_jax_state_dict
    preset = request.param
    paddle.seed(0)
    jm = LlamaForCausalLM(preset)
    jm.eval()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    if jm.config.attention_bias:
        # zero at initialisation: give the biases values to exercise
        rng = np.random.RandomState(5)
        for name in ("bq", "bk", "bv"):
            state[name] = (rng.randn(*state[name].shape) * 0.1).astype(
                np.float32)
        jm.set_state_dict(state)
    p = jm._parameters
    embed = p["embed_tokens"]._value
    jw = ({n: p[n]._value for n in jm._stacked_names()}, embed,
          p["final_norm"]._value,
          p["lm_head"]._value if p.get("lm_head") is not None else embed.T)
    cfg = jm.config
    step = m.jax.jit(lambda *a: m.jl.mixed_paged_step(cfg, *jw, *a))
    pm = from_jax_state_dict(state, preset, device="cpu")
    return types.SimpleNamespace(preset=preset, jm=jm, cfg=cfg, step=step,
                                 pm=pm)


def _step_inputs(cfg, int8, n_blocks=14, bs=8, seed=3):
    """Pools holding earlier tokens, and a window batch of a 16-slot
    chunk at offset 0 (one full page and a partial one), a chunk deep in
    its row ending mid-page, a verify window of a decode lane, one plain
    decode token and an idle lane."""
    rng = np.random.RandomState(seed)
    L, kvh, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, \
        cfg.head_dim
    shape = (L, n_blocks, bs, kvh, hd)
    if int8:
        pools = [rng.randint(-127, 128, shape).astype(np.int8)
                 for _ in range(2)]
        pools += [((rng.rand(L, n_blocks, kvh) + 0.5) / 127).astype(
            np.float32) for _ in range(2)]
    else:
        pools = [rng.randn(*shape).astype(np.float32) * 0.5
                 for _ in range(2)]
    tables = np.asarray([[3, 7, 0, 0, 0], [1, 5, 9, 11, 0], [2, 4, 0, 0, 0],
                         [6, 0, 0, 0, 0], [0, 0, 0, 0, 0]], np.int32)
    q_lens = np.asarray([12, 9, 3, 1, 0], np.int32)
    kv_lens = np.asarray([12, 29, 15, 6, 0], np.int32)
    ids = np.zeros((5, 16), np.int32)
    for b, n in enumerate(q_lens):
        ids[b, :n] = rng.randint(1, 128, n)
    return [ids, q_lens, kv_lens, tables], pools


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_mixed_step_matches_jax(m, ref, kv):
    """The step unsharded and over two CPU ranks, each on fresh copies
    of the pools: the JAX step's tokens, and its pools on every page but
    the NULL page, where padding slots and idle lanes race."""
    torch, sh = m.torch, m.sharding
    data, pools = _step_inputs(ref.cfg, kv == "int8")
    want, *jpools = ref.step(*_j(m, *data, *pools))
    want, jpools = np.asarray(want), [np.asarray(p) for p in jpools]
    st, embed, fnorm, head = ref.pm.weights()
    devs = [torch.device("cpu")] * 2
    dims = sh.pool_specs(len(pools))
    for tp in (1, 2):
        tpools = _t(m, *pools)
        args = tpools if tp == 1 else \
            [sh.shard(p, d, devs) for p, d in zip(tpools, dims)]
        w = st if tp == 1 else sh.shard_weights(st, devs)
        with torch.no_grad():
            got = m.tl.mixed_paged_step(
                ref.pm.config, w, embed, fnorm, head,
                torch.from_numpy(data[0]).long(),
                *_t(m, *data[1:]), *args)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        if tp == 2:
            args = [torch.cat(a, dim=d) for a, d in zip(args, dims)]
        for a, j in zip(args, jpools):
            if a.dtype == torch.float32 and kv == "fp":   # fp32 K/V
                np.testing.assert_allclose(a[:, 1:].numpy(), j[:, 1:],
                                           rtol=0, atol=1e-5)
            else:                                  # int8 codes, scales
                np.testing.assert_array_equal(a[:, 1:].numpy(), j[:, 1:])


# -- the mesh engine ---------------------------------------------------------

ENGINE = dict(capacity=4, s_max=64, chunk=4, block_size=8)
ALL_FEATURES = dict(prefix_cache=True, chunked_prefill=True,
                    spec_decode=True, kv_dtype="int8")


def _waves():
    """The reference's all-features oracle (tests/test_tp_sharding.py):
    a repeating prompt and a 10-token prompt that seeds the cache, then
    a prompt that hits it mid-page (copy-on-write) and a 19-token one."""
    rng = np.random.RandomState(0)
    shared = rng.randint(1, 128, (10,)).astype(np.int32)
    wave1 = [np.tile(rng.randint(1, 128, (5,)).astype(np.int32), 4), shared]
    wave2 = [np.concatenate([shared, rng.randint(1, 128, (7,)).astype(
        np.int32)]), rng.randint(1, 128, (19,)).astype(np.int32)]
    return [wave1, wave2]


def _serve(eng, waves, max_new=10):
    outs = []
    for wave in waves:
        reqs = [eng.submit(p, max_new_tokens=max_new) for p in wave]
        eng.admit([])
        for _ in range(1000):
            eng.decode_once()
            eng.admit([])
            if eng.idle():
                break
        outs += [np.asarray(r.wait(timeout=1)) for r in reqs]
    return outs


COUNTERS = ("device_steps", "device_calls", "prefill_chunks",
            "prefix_hit_tokens", "prefills", "admitted", "retired")


@pytest.fixture(scope="module")
def jax_tp2():
    """The JAX engine at tp=2 on the all-features oracle (debug)."""
    import paddle_tpu as paddle
    from paddle_tpu.inference.serving import DecodeEngine
    from paddle_tpu.inference.sharding import make_tp_mesh
    from paddle_tpu.models.llama import LlamaForCausalLM
    paddle.seed(0)
    jm = LlamaForCausalLM("debug")
    jm.eval()
    eng = DecodeEngine(jm, **ENGINE, mesh=make_tp_mesh(2), **ALL_FEATURES)
    outs = _serve(eng, _waves())
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    return outs, eng.stats(), state


def test_tp2_engine_matches_jax_tp2_engine(m, jax_tp2):
    want, w, state = jax_tp2
    from paddle_tpu_torch.convert import from_jax_state_dict
    pm = from_jax_state_dict(state, "debug", device="cpu")
    DecodeEngine = m.serving.DecodeEngine
    runs = {}
    for name, mesh in (
            ("tp2", m.sharding.make_tp_mesh(2, devices=["cpu", "cpu"])),
            ("tp1", m.sharding.make_tp_mesh(1, devices=["cpu"])),
            ("none", None)):
        eng = DecodeEngine(pm, **ENGINE, mesh=mesh, **ALL_FEATURES)
        runs[name] = (_serve(eng, _waves()), eng.stats())
    outs, s = runs["tp2"]
    for got, exp in zip(outs, want):
        np.testing.assert_array_equal(got, exp)
    for key in COUNTERS:
        assert s[key] == w[key], key
    assert s["spec"]["proposed"] == w["spec"]["proposed"] > 0
    assert s["spec"]["accepted"] == w["spec"]["accepted"]
    assert s["prefix_hit_tokens"] > 0 and s["prefill_chunks"] > 0
    assert s["tp_degree"] == 2 and s["mesh_shape"] == {"tp": 2}
    # one rank: the same tokens and schedule; no mesh: the same tokens
    # through the per-row paths, in more device calls
    assert {k: runs["tp1"][1][k] for k in COUNTERS} == \
        {k: s[k] for k in COUNTERS}
    for name in ("tp1", "none"):
        for got, exp in zip(runs[name][0], want):
            np.testing.assert_array_equal(got, exp)
    assert s["device_calls"] < runs["none"][1]["device_calls"]
    assert "mesh_shape" not in runs["none"][1]


def test_tiny_tp4_engine_tokens(m):
    """tiny (4 kv heads) at tp=4, one kv head per rank, against the
    unsharded engine: the same tokens."""
    torch = m.torch
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    pm = LlamaForCausalLM("tiny", device="cpu",
                          generator=torch.Generator().manual_seed(1))
    rng = np.random.RandomState(1)
    prompts = [[rng.randint(1, 900, (n,)).astype(np.int32)
                for n in (9, 17)]]
    kw = dict(ENGINE, chunked_prefill=True, spec_decode=True)
    mesh = m.sharding.make_tp_mesh(4, devices=["cpu"] * 4)
    eng = m.serving.DecodeEngine(pm, mesh=mesh, **kw)
    got = _serve(eng, prompts, max_new=8)
    want = _serve(m.serving.DecodeEngine(pm, **kw), prompts, max_new=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.stats()["mesh_shape"] == {"tp": 4}
    assert [k.shape[3] for k in eng._kp] == [1] * 4


def test_mesh_errors(m):
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    sh, DecodeEngine = m.sharding, m.serving.DecodeEngine
    pm = LlamaForCausalLM("debug", device="cpu")
    cpu2 = sh.make_tp_mesh(2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="requires the paged engine"):
        DecodeEngine(pm, paged=False, mesh=cpu2)
    with pytest.raises(ValueError, match="no tp_axis='model'"):
        DecodeEngine(pm, mesh=cpu2, tp_axis="model")
    with pytest.raises(ValueError, match="needs 3 devices, have 2"):
        sh.make_tp_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        sh.make_tp_mesh(2)                  # no CUDA device here
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 4"):
        DecodeEngine(pm, mesh=sh.make_mesh(1, 2, devices=["cpu"] * 2))
    # debug: 4 heads, 2 kv heads, ff 172 -> every constraint in one line
    with pytest.raises(ValueError) as err:
        DecodeEngine(pm, mesh=sh.make_tp_mesh(3, devices=["cpu"] * 3))
    msg = str(err.value)
    assert msg.startswith("invalid mesh config: ")
    for part in ("num_key_value_heads=2 not divisible by tp=3",
                 "exceeds the 2 kv heads outright",
                 "num_attention_heads=4 not divisible by tp=3",
                 "intermediate_size=172 not divisible by tp=3"):
        assert part in msg, part
    eng = DecodeEngine(pm, mesh=sh.make_mesh(2, 1, devices=["cpu"] * 2))
    assert eng.stats()["mesh_shape"] == {"seq": 1, "tp": 2}
    assert sh.same_pool_placement(None, None)
    assert not sh.same_pool_placement(cpu2, None)
    assert sh.same_pool_placement(cpu2, sh.make_tp_mesh(2, ["cpu"] * 2))


def test_sharding_specs_match_the_reference(m):
    from paddle_tpu.inference import sharding as jsh
    names = ["wq", "wk", "wv", "wo", "bq", "bk", "bv", "input_ln",
             "post_ln", "w_gate", "w_up", "w_down", "we_gate", "we_down"]
    mine = m.sharding.stacked_weight_specs(names)
    for n, spec in jsh.stacked_weight_specs(names).items():
        split = [i for i, a in enumerate(spec) if a == "tp"]
        assert mine[n] == (split[0] if split else None), n
    for n_pool in (2, 4):
        assert m.sharding.pool_specs(n_pool) == tuple(
            list(s).index("tp") for s in jsh.pool_specs(n_pool))


# -- the wrapper around the CUDA kernel --------------------------------------

def test_wrapper_runs_plain_version_on_cpu_and_counts_nothing(m):
    args = _t(m, *_mixed_case(seed=5, T=16, kv_lens=(9, 20), q_lens=(9, 1)))
    before = dict(m.pa.launch_counts)
    out = m.pa.verify_chunk_scores(*args)
    assert m.torch.equal(out, m.pa.mixed_attn_reference(*args))
    assert dict(m.pa.launch_counts) == before
    with pytest.raises(ValueError, match="no kernel"):
        m.pa.mixed_paged_attention(*(a.to("meta") for a in args))


@pytest.mark.parametrize("split_keys", [8, 16, 32])
def test_split_then_merge_matches_references(m, split_keys):
    """The plain versions of the kernel's two passes: partials over
    splits of ``split_keys`` keys, then merge_softmax_partials, against
    mixed_attn_reference and the reference's _mixed_attn_reference.
    Rows: kv_len 0 (exact zeros), one decode token over 5 keys (shorter
    than a split; the later splits hold no visible key and give
    m = -1e30, l = 0, acc = 0), a 12-token prefill window at 28..39
    that crosses the split boundary at 32, and a 3-token window."""
    arrays = _mixed_case(seed=41, T=16, kv_lens=(0, 5, 40, 45),
                         q_lens=(0, 1, 12, 3), max_blocks=6)
    t = _t(m, *arrays)
    parts = m.pa.mixed_attn_partials(*t, split_keys=split_keys)
    n_splits = -(-48 // split_keys)
    assert [tuple(x.shape[:2]) for x in parts] == [(n_splits, 4)] * 3
    ml, ll, acc = (x[1:, 1, 0] for x in parts)      # row 1, splits >= 1
    assert bool((ml == -1e30).all() and (ll == 0).all()
                and (acc == 0).all())
    got = m.pa.merge_softmax_partials(*parts, dim=0).numpy()
    _valid_close(got, m.pa.mixed_attn_reference(*t).numpy(), arrays[5])
    want = np.asarray(m.jpa._mixed_attn_reference(*_j(m, *arrays)))
    _valid_close(got, want, arrays[5])
    np.testing.assert_array_equal(got[0], 0.0)
    assert np.isfinite(got).all()


def test_cuda_launch_counts_by_route_with_its_workspace(m, monkeypatch):
    """The CUDA wrapper with the library and the C call stubbed (nothing
    is built or launched): each call passes a workspace of
    mixed_workspace_floats elements, whose split count comes from the
    table's width alone, and counts one launch under its kernel and its
    route (tensor cores for bf16/fp16, CUDA cores for fp32)."""
    torch, pa = m.torch, m.pa
    calls = []
    monkeypatch.setattr(pa._build, "load", lambda name, bind:
                        types.SimpleNamespace(mixed_paged_attention="fn"))
    monkeypatch.setattr(pa, "_call_mixed", lambda fn, args, device:
                        calls.append(args) or 0)
    pa.launch_counts.clear()
    pa.route_counts.clear()
    assert pa.mixed_splits(100, 16) == 7 and pa.mixed_splits(1, 8) == 1
    i32 = dict(dtype=torch.int32)
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        kp = torch.zeros(9, 16, 2, 32, dtype=dt)
        pa._launch_mixed(torch.zeros(3, 16, 2, 4, 32, dtype=dt), kp,
                         kp.clone(), torch.zeros(3, 20, **i32),
                         torch.full((3,), 7, **i32), torch.ones(3, **i32))
    n_ws = pa.mixed_workspace_floats(3, 16, 2, 4, 32, 20, 16)
    assert n_ws == 2 * 3 * 2 * 16 * 4 * 34
    assert [a[8:] for a in calls] == [
        (n_ws, 3, 16, 2, 4, 32, 16, 20, code, 1 / 32 ** 0.5)
        for code in (2, 1, 0)]
    assert pa.launch_counts == {"mixed_paged": 3}
    assert pa.route_counts == {"mixed_paged/tensor_core": 2,
                               "mixed_paged/cuda_core": 1}
    monkeypatch.setattr(pa, "_call_mixed", lambda fn, args, device: -1)
    with pytest.raises(RuntimeError, match="unsupported arguments"):
        pa._launch_mixed(torch.zeros(3, 16, 2, 4, 32), kp.float(),
                         kp.float(), torch.zeros(3, 20, **i32),
                         torch.zeros(3, **i32), torch.zeros(3, **i32))
    assert pa.launch_counts == {"mixed_paged": 3}


def test_kernel_args_accept_the_engine_shapes(m):
    torch = m.torch
    i32 = dict(dtype=torch.int32)
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        for T in (16, 128):
            kp = torch.zeros(401, 16, 8, 128, dtype=dt)
            m.pa.check_mixed_args(torch.zeros(4, T, 8, 4, 128, dtype=dt), kp,
                                  kp.clone(), torch.zeros(4, 101, **i32),
                                  torch.zeros(4, **i32),
                                  torch.zeros(4, **i32))


@pytest.mark.parametrize("case", ["rank", "pool_dtype", "len_dtype",
                                  "group", "head_dim", "block_size",
                                  "contiguity", "lens_shape"])
def test_kernel_args_reject(m, case):
    torch = m.torch
    q = torch.zeros(2, 16, 2, 2, 16)
    kp = vp = torch.zeros(6, 8, 2, 16)
    table = torch.zeros(2, 3, dtype=torch.int32)
    kv = ql = torch.zeros(2, dtype=torch.int32)
    if case == "rank":
        q = q[:, 0]
    elif case == "pool_dtype":
        kp = vp = kp.double()
    elif case == "len_dtype":
        kv = kv.long()
    elif case == "group":
        q = torch.zeros(2, 16, 2, 9, 16)
    elif case == "head_dim":
        q, kp, vp = q[..., :8], kp[..., :8], vp[..., :8]
    elif case == "block_size":
        kp = vp = torch.zeros(6, 12, 2, 16)
    elif case == "contiguity":
        q = torch.zeros(2, 2, 16, 2, 16).transpose(1, 2)
    elif case == "lens_shape":
        ql = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        m.pa.check_mixed_args(q, kp, vp, table, kv, ql)


def test_c_interface_matches_the_ctypes_binding(m, monkeypatch):
    """The source cannot be compiled here: its exported function takes as
    many arguments as the binding declares, and it builds like the
    others."""
    from paddle_tpu_torch.kernels import _build
    src = (_build.CSRC / "mixed_paged.cu").read_text()
    found = re.search(r'extern "C" int mixed_paged_attention\(([^)]*)\)',
                      src)
    assert found, "exported C function not found"
    lib = types.SimpleNamespace(mixed_paged_attention=types.SimpleNamespace())
    m.pa._bind_mixed(lib)
    n_params = len(found.group(1).split(","))
    assert len(lib.mixed_paged_attention.argtypes) == n_params == 19
    assert "sm_90a" in src and "_mixed_kernel" in src
    split = re.search(r"constexpr int kSplit = (\d+);", src)
    assert split and int(split.group(1)) == m.pa.MIXED_SPLIT_KEYS
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build.nvcc_command("mixed_paged",
                              _build.library_path("mixed_paged"))
    assert cmd[-1].endswith("csrc/mixed_paged.cu")
    assert "arch=compute_90a,code=sm_90a" in cmd
