"""The port's int8 paged KV against the JAX reference.

The plain version of the int8 decode kernel (``paged_attn_reference_int8``,
block-looped over pages through ``int8_block_update`` as the reference
is) is held against the JAX package's ``_paged_attn_reference_int8`` and,
in one small case, its Pallas kernel in interpret mode. The quantized
writes (``_quantized_token_insert``, ``_quantized_prefill_scatter``), the
dequantizing gather and the int8 decode step and tail prefill are held
against their JAX counterparts on the same seeded numpy inputs. The CUDA
kernel itself runs only on the card, where ``chip_smoke.py`` compiles it
and compares it with the plain version; here its wrapper's CPU dispatch,
argument checks and C interface are checked.

Tolerances: int8 codes and scatter-max scales are computed by the same
float32 operations in both packages and must be equal; attention outputs
differ only by summation order and ``exp`` rounding, at most 1e-6 on
values of order 1. torch, the port and JAX are imported inside fixtures.
"""

import re
import types

import numpy as np
import pytest

TOL = 1e-6


@pytest.fixture(scope="module")
def m():
    import jax.numpy as jnp
    import torch
    from paddle_tpu.kernels import paged_attention as jpa
    from paddle_tpu.models import llama as jl
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models import llama as tl
    return types.SimpleNamespace(torch=torch, jnp=jnp, jpa=jpa, jl=jl,
                                 pa=pa, tl=tl)


def _t(m, *arrays):
    return [m.torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(m, *arrays):
    return [m.jnp.asarray(a) for a in arrays]


def _int8_case(seed, bs=16, lens=(37, 0, 1, 32)):
    """Random codes in [-127, 127] and positive per-(page, head) scales
    of 0.5/127 to 1.5/127, so that the dequantized values are of order 1
    as the engine's are; ragged rows over scattered pages, unused table
    entries on the NULL page. B=4, kvh=2, G=4, hd=32, 20 pages."""
    B, kvh, G, hd, n_blocks = 4, 2, 4, 32, 20
    rng = np.random.RandomState(seed)
    q = rng.randn(B, kvh, G, hd).astype(np.float32)
    kp = rng.randint(-127, 128, (n_blocks, bs, kvh, hd)).astype(np.int8)
    vp = rng.randint(-127, 128, (n_blocks, bs, kvh, hd)).astype(np.int8)
    ks = ((rng.rand(n_blocks, kvh) + 0.5) / 127).astype(np.float32)
    vs = ((rng.rand(n_blocks, kvh) + 0.5) / 127).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    table = np.zeros((B, 6), np.int32)
    free = list(rng.permutation(np.arange(1, n_blocks)))
    for b in range(B):
        for j in range(-(-int(lens[b]) // bs)):
            table[b, j] = free.pop()
    return q, kp, vp, table, lens, ks, vs


@pytest.mark.parametrize("bs", [8, 16])
def test_int8_reference_matches_jax_reference(m, bs):
    """Rows of 37, 0, 1 and 2 pages' worth of keys; the empty row gives
    zeros in both."""
    q, kp, vp, table, lens, ks, vs = _int8_case(seed=bs, bs=bs,
                                                lens=(37, 0, 1, 2 * bs))
    want = np.asarray(m.jpa._paged_attn_reference_int8(
        *_j(m, q, kp, vp, table, lens), tuple(_j(m, ks, vs))))
    tq, tkp, tvp, ttab, tlens, tks, tvs = _t(m, q, kp, vp, table, lens,
                                             ks, vs)
    got = m.pa.paged_attn_reference_int8(tq, tkp, tvp, ttab, tlens,
                                         (tks, tvs)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_array_equal(want[1], 0.0)


def test_int8_reference_matches_interpret_kernel(m):
    """The TPU kernel in interpret mode, at the shapes and on the data of
    the reference's own interpret test (scales up to 0.1, so values up
    to 12.7): within 1e-6 of the output's largest magnitude."""
    rng = np.random.RandomState(22)
    B, kvh, G, hd, N, bs = 3, 2, 2, 16, 8, 16
    q = rng.randn(B, kvh, G, hd).astype(np.float32)
    kp = rng.randint(-127, 128, (N, bs, kvh, hd)).astype(np.int8)
    vp = rng.randint(-127, 128, (N, bs, kvh, hd)).astype(np.int8)
    ks = rng.rand(N, kvh).astype(np.float32) * 0.1
    vs = rng.rand(N, kvh).astype(np.float32) * 0.1
    tables = rng.permutation(np.arange(1, 7))[:6].reshape(3, 2).astype(
        np.int32)
    lens = np.asarray([5, 16, 23], np.int32)
    want = np.asarray(m.jpa.paged_attention_pallas(
        *_j(m, q, kp, vp, tables, lens), interpret=True,
        kv_scales=tuple(_j(m, ks, vs))))
    got = m.pa.paged_attn_reference_int8(
        *_t(m, q, kp, vp, tables, lens), tuple(_t(m, ks, vs))).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


@pytest.fixture(scope="module")
def split_case(m):
    """Rows that end on a 64-key boundary, one key past it, at length 0
    and at the table's full width (96), and the JAX
    ``_paged_attn_reference_int8`` on them (run once)."""
    arrays = _int8_case(seed=6, bs=16, lens=(64, 65, 0, 96))
    q, kp, vp, table, lens, ks, vs = arrays
    want = np.asarray(m.jpa._paged_attn_reference_int8(
        *_j(m, q, kp, vp, table, lens), tuple(_j(m, ks, vs))))
    return arrays, want


@pytest.mark.parametrize("split_keys", [32, 64])
def test_int8_decode_partials_merge_to_the_references(m, split_case,
                                                      split_keys):
    """The int8 kernels' split pass in plain PyTorch
    (``decode_attn_partials`` with scales: raw-code dots scaled per key,
    p scaled by vscale), merged by ``merge_softmax_partials``: equal to
    paged_attn_reference_int8 and to the JAX
    ``_paged_attn_reference_int8`` within 2e-5 (fp32 sums by splits,
    the scales applied at other places), zeros at length 0."""
    arrays, jax_want = split_case
    tq, tkp, tvp, ttab, tlens, tks, tvs = _t(m, *arrays)
    parts = m.pa.decode_attn_partials(tq, tkp, tvp, ttab, tlens,
                                      split_keys=split_keys,
                                      kv_scales=(tks, tvs))
    assert parts[0].shape[0] == -(-96 // split_keys)
    got = m.pa.merge_softmax_partials(*parts).numpy()
    want = m.pa.paged_attn_reference_int8(tq, tkp, tvp, ttab, tlens,
                                          (tks, tvs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, jax_want, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got[2], 0.0)


def test_int8_block_update_matches_jax_on_one_cell(m):
    """The one-page helper with the reference's single-cell signature,
    on a page whose tail lies past the row's length."""
    torch = m.torch
    rng = np.random.RandomState(3)
    G, bs, hd = 4, 8, 16
    q = rng.randn(G, hd).astype(np.float32)
    kc = rng.randint(-127, 128, (bs, hd)).astype(np.int8)
    vc = rng.randint(-127, 128, (bs, hd)).astype(np.int8)
    ks, vs = np.float32(0.011), np.float32(0.007)
    mm = rng.randn(G).astype(np.float32)
    ll = rng.rand(G).astype(np.float32) + 1
    acc = rng.randn(G, hd).astype(np.float32)
    k_ids = (8 + np.arange(bs))[None, :].repeat(G, 0).astype(np.int32)
    n = np.int32(13)
    want = m.jpa._int8_block_update(*_j(m, q, kc, vc, ks, vs, mm, ll, acc,
                                        k_ids, n), 0.25)
    got = m.pa.int8_block_update(*_t(m, q, kc, vc), torch.tensor(ks),
                                 torch.tensor(vs), *_t(m, mm, ll, acc,
                                                       k_ids),
                                 torch.tensor(n), 0.25)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)


def test_gather_pages_dequant_matches_jax(m):
    q, kp, vp, table, lens, ks, vs = _int8_case(seed=4)
    want = np.asarray(m.jpa.gather_pages_dequant(*_j(m, kp, table, ks)))
    got = m.pa.gather_pages_dequant(*_t(m, kp, table, ks)).numpy()
    np.testing.assert_array_equal(got, want)


def test_quantized_token_insert_matches_jax(m):
    """Three inserts into one pool: two rows on fresh pages, then a
    larger token that re-expresses a page, a smaller one that leaves it
    bit for bit (ratio exactly 1.0), and an inactive row on the NULL
    page. Codes equal, scales within 1e-6 relative."""
    from paddle_tpu_torch.kernels.paged_attention import KV_SCALE_EPS
    rng = np.random.RandomState(20)
    N, bs, kvh, hd = 6, 8, 3, 16
    pool = np.zeros((N, bs, kvh, hd), np.int8)
    scales = np.full((N, kvh), KV_SCALE_EPS, np.float32)
    jpool, jsc = _j(m, pool, scales)
    tpool, tsc = _t(m, pool, scales)
    steps = [([1, 2, 0], [0, 5, 0], 1.0), ([1, 2, 0], [1, 6, 0], 4.0),
             ([1, 2, 0], [2, 7, 0], 0.01)]
    for page, off, mag in steps:
        tok = (rng.randn(3, kvh, hd) * mag).astype(np.float32)
        page, off = np.asarray(page, np.int32), np.asarray(off, np.int32)
        before = tpool.clone()
        jpool, jsc = m.jl._quantized_token_insert(
            jpool, jsc, *_j(m, page, off, tok))
        m.tl._quantized_token_insert(tpool, tsc, *_t(m, page, off, tok))
        np.testing.assert_array_equal(tpool[1:].numpy(),
                                      np.asarray(jpool)[1:])
        np.testing.assert_allclose(tsc[1:].numpy(), np.asarray(jsc)[1:],
                                   rtol=1e-6, atol=0)
    # the last, small token raised no max: the resident codes of its
    # pages are bit-identical apart from the slot it wrote
    for row, pg in enumerate((1, 2)):
        keep = np.ones(bs, bool)
        keep[steps[-1][1][row]] = False
        np.testing.assert_array_equal(tpool[pg, keep].numpy(),
                                      before[pg, keep].numpy())


def test_quantized_prefill_scatter_matches_jax(m):
    """One prompt of 21 tokens (3 pad slots) over a 3-page table whose
    first page is a full shared page already in the pool: scales take
    the scatter-max over the many tokens of each page, the row's pages
    are re-expressed, and the shared page (ratio exactly 1.0) keeps its
    codes bit for bit."""
    from paddle_tpu_torch.kernels.paged_attention import KV_SCALE_EPS
    rng = np.random.RandomState(21)
    L, N, bs, kvh, hd = 2, 7, 8, 2, 16
    pool = np.zeros((L, N, bs, kvh, hd), np.int8)
    scales = np.full((L, N, kvh), KV_SCALE_EPS, np.float32)
    shared = 4
    pool[:, shared] = rng.randint(-127, 128, (L, bs, kvh, hd))
    scales[:, shared] = 0.02
    table = np.asarray([shared, 2, 5, 0, 0], np.int32)
    sp, pad, offset = 24, 3, 8
    toks = (rng.randn(L, sp, kvh, hd) * 2).astype(np.float32)
    j = np.arange(sp)
    valid = j >= pad
    cpos = np.maximum(j - pad, 0) + offset
    page = np.where(valid, table[cpos // bs], 0).astype(np.int32)
    off = np.where(valid, cpos % bs, 0).astype(np.int32)
    jpool, jsc = m.jl._quantized_prefill_scatter(
        *_j(m, pool, scales, toks, page, off, valid, table))
    tpool, tsc = _t(m, pool, scales)
    m.tl._quantized_prefill_scatter(tpool, tsc, *_t(m, toks, page, off,
                                                    valid, table))
    np.testing.assert_array_equal(tpool[:, 1:].numpy(),
                                  np.asarray(jpool)[:, 1:])
    np.testing.assert_allclose(tsc[:, 1:].numpy(), np.asarray(jsc)[:, 1:],
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tpool[:, shared].numpy(), pool[:, shared])
    # duplicate pages in one scatter take the max, not the last write
    amax = np.abs(toks).max(-1) / 127.0                    # [L, sp, kvh]
    for pg in (2, 5):
        np.testing.assert_array_equal(
            tsc[:, pg].numpy(), amax[:, valid & (page == pg)].max(1))


def test_recycled_page_scale_resets_on_a_live_engine(m):
    """A page freed by one tenant and handed out again must drop the
    old running-max scale before its next write."""
    from paddle_tpu_torch.inference.serving import DecodeEngine
    from paddle_tpu_torch.kernels.paged_attention import KV_SCALE_EPS
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    model = LlamaForCausalLM("debug", device="cpu")
    eng = DecodeEngine(model, capacity=2, s_max=64, chunk=4, block_size=8,
                       prefix_cache=False, kv_dtype="int8")
    assert eng._alloc.track_allocations
    (pg,) = eng._alloc.allocate(1)
    eng._drain_scale_resets()
    eng._kscale[:, pg] = 9.0            # a tenant wrote outliers
    eng._vscale[:, pg] = 9.0
    eng._alloc.free([pg])
    assert eng._alloc.allocate(1) == [pg]   # LIFO: the same page back
    eng._drain_scale_resets()
    assert (eng._kscale[:, pg] == np.float32(KV_SCALE_EPS)).all()
    assert (eng._vscale[:, pg] == np.float32(KV_SCALE_EPS)).all()
    assert eng.stats()["kv_dtype"] == "int8"
    assert eng._kp.dtype == m.torch.int8
    fp = DecodeEngine(model, capacity=2, s_max=64, chunk=4, block_size=8,
                      prefix_cache=False)
    fp._alloc.allocate(2)
    assert fp._alloc.drain_allocated() == []


# -- the int8 model step against the reference ------------------------------

@pytest.fixture(scope="module")
def ref(m):
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.convert import from_jax_state_dict
    paddle.seed(0)
    jm = LlamaForCausalLM("debug")
    jm.eval()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    p = jm._parameters
    jw = ({n: p[n]._value for n in jm._stacked_names()},
          p["embed_tokens"]._value, p["final_norm"]._value,
          p["lm_head"]._value)
    pm = from_jax_state_dict(state, "debug", device="cpu")
    return types.SimpleNamespace(jm=jm, jw=jw, pm=pm, cfg=jm.config)


def _int8_pools(cfg, n_blocks=12, bs=8, seed=3):
    rng = np.random.RandomState(seed)
    L, kvh, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, \
        cfg.head_dim
    shape = (L, n_blocks, bs, kvh, hd)
    kp = rng.randint(-127, 128, shape).astype(np.int8)
    vp = rng.randint(-127, 128, shape).astype(np.int8)
    ksc = ((rng.rand(L, n_blocks, kvh) + 0.5) / 127).astype(np.float32)
    vsc = ((rng.rand(L, n_blocks, kvh) + 0.5) / 127).astype(np.float32)
    return kp, vp, ksc, vsc


def test_int8_decode_step_and_tail_prefill_match_jax(m, ref):
    """A prefix-hit tail prefill into int8 pools (tail landing mid-page
    through a table whose last entries are NULL), then one int8 decode
    step over two live rows and an inactive all-NULL row: logits within
    1e-5, codes equal and scales within 1e-6 relative on every page but
    the NULL page."""
    torch = m.torch
    kp, vp, ksc, vsc = _int8_pools(ref.cfg)
    jpools = _j(m, kp, vp, ksc, vsc)
    tpools = _t(m, kp, vp, ksc, vsc)
    table = np.asarray([4, 9, 2, 0, 0], np.int32)
    ids = np.zeros((1, 16), np.int32)
    ids[0, 11:] = np.random.RandomState(9).randint(1, 128, 5)
    pad, plen = np.asarray([11], np.int32), np.asarray([11], np.int32)
    want, *jpools = m.jl.prefix_prefill(
        ref.cfg, *ref.jw, *_j(m, ids, pad, plen), jpools[0], jpools[1],
        m.jnp.asarray(table), kv_scales=(jpools[2], jpools[3]))
    got = m.tl.prefix_prefill(
        ref.pm.config, *ref.pm.weights(), torch.from_numpy(ids).long(),
        torch.from_numpy(pad).long(), torch.from_numpy(plen).long(),
        tpools[0], tpools[1], torch.from_numpy(table),
        kv_scales=(tpools[2], tpools[3]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)

    def same_pools():
        for t, j in zip(tpools[:2], jpools[:2]):
            np.testing.assert_array_equal(t[:, 1:].numpy(),
                                          np.asarray(j)[:, 1:])
        for t, j in zip(tpools[2:], jpools[2:]):
            np.testing.assert_allclose(t[:, 1:].numpy(),
                                       np.asarray(j)[:, 1:], rtol=1e-6,
                                       atol=0)

    same_pools()
    tables = np.asarray([[4, 9, 2, 0, 0], [5, 0, 0, 0, 0],
                         [0, 0, 0, 0, 0]], np.int32)
    lens = np.asarray([16, 7, 0], np.int32)
    tok = np.asarray([17, 42, 0], np.int32)
    want, *jpools = m.jl._paged_decode_step(
        ref.cfg, *ref.jw, *_j(m, tok), jpools[0], jpools[1],
        *_j(m, tables, lens), jpools[2], jpools[3])
    got = m.tl._paged_decode_step(
        ref.pm.config, *ref.pm.weights(), torch.from_numpy(tok).long(),
        tpools[0], tpools[1], *_t(m, tables, lens), tpools[2], tpools[3])
    np.testing.assert_allclose(got[:2].numpy(), np.asarray(want)[:2],
                               rtol=0, atol=1e-5)
    same_pools()


# -- the wrapper around the CUDA kernel -------------------------------------

def test_int8_wrapper_runs_plain_version_on_cpu_and_counts_nothing(m):
    q, kp, vp, table, lens, ks, vs = _t(m, *_int8_case(seed=5))
    before = dict(m.pa.launch_counts)
    out = m.pa.paged_decode_attention(q, kp, vp, table, lens,
                                      kv_scales=(ks, vs))
    assert m.torch.equal(out, m.pa.paged_attn_reference_int8(
        q, kp, vp, table, lens, (ks, vs)))
    assert dict(m.pa.launch_counts) == before
    with pytest.raises(ValueError, match="no kernel"):
        m.pa.paged_decode_attention(
            *(a.to("meta") for a in (q, kp, vp, table, lens)),
            kv_scales=(ks.to("meta"), vs.to("meta")))


def test_int8_kernel_args_accept_the_engine_shapes(m):
    torch = m.torch
    for qdt in (torch.bfloat16, torch.float16, torch.float32):
        q = torch.zeros(4, 8, 4, 128, dtype=qdt)
        kp = torch.zeros(401, 16, 8, 128, dtype=torch.int8)
        sc = torch.ones(401, 8)
        m.pa.check_kernel_args(q, kp, kp.clone(),
                               torch.zeros(4, 101, dtype=torch.int32),
                               torch.zeros(4, dtype=torch.int32),
                               (sc, sc.clone()))


@pytest.mark.parametrize("case", [
    "fp_pools", "scale_dtype", "scale_shape", "one_scale", "q_dtype",
    "scale_contiguity", "block_size"])
def test_int8_kernel_args_reject(m, case):
    torch = m.torch
    q = torch.zeros(2, 2, 2, 16)
    kp = torch.zeros(6, 8, 2, 16, dtype=torch.int8)
    vp = torch.zeros(6, 8, 2, 16, dtype=torch.int8)
    scales = (torch.ones(6, 2), torch.ones(6, 2))
    if case == "fp_pools":
        kp, vp = kp.float(), vp.float()
    elif case == "scale_dtype":
        scales = (scales[0].double(), scales[1])
    elif case == "scale_shape":
        scales = (torch.ones(6, 3), torch.ones(6, 3))
    elif case == "one_scale":
        scales = (scales[0],)
    elif case == "q_dtype":
        q = q.to(torch.int8)
    elif case == "scale_contiguity":
        scales = (torch.ones(2, 6).T, scales[1])
    elif case == "block_size":
        kp = vp = torch.zeros(6, 12, 2, 16, dtype=torch.int8)
    with pytest.raises(ValueError):
        m.pa.check_kernel_args(q, kp, vp,
                               torch.zeros(2, 3, dtype=torch.int32),
                               torch.zeros(2, dtype=torch.int32), scales)


def test_int8_c_interface_matches_the_ctypes_binding(m, monkeypatch):
    """The source cannot be compiled here, so check that its exported
    function takes as many arguments as the binding declares, and that
    it builds with the same command as the fp kernel."""
    from paddle_tpu_torch.kernels import _build
    src = (_build.CSRC / "paged_decode_int8.cu").read_text()
    found = re.search(r'extern "C" int paged_decode_int8_attention\('
                      r'([^)]*)\)', src)
    assert found, "exported C function not found"
    lib = types.SimpleNamespace(
        paged_decode_int8_attention=types.SimpleNamespace())
    m.pa._bind_int8(lib)
    n_params = len(found.group(1).split(","))
    assert len(lib.paged_decode_int8_attention.argtypes) == n_params == 19
    assert "sm_90a" in src and "_paged_kernel_int8" in src
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build.nvcc_command("paged_decode_int8", _build.library_path(
        "paged_decode_int8"))
    assert cmd[-1].endswith("csrc/paged_decode_int8.cu")
    assert "arch=compute_90a,code=sm_90a" in cmd


def test_allocator_logs_hand_outs_only_when_tracking():
    from paddle_tpu_torch.inference.paged_cache import BlockAllocator
    a = BlockAllocator(9)
    a.allocate(2)
    assert a.drain_allocated() == []
    a.track_allocations = True
    first = a.allocate(2)
    a.free(first)
    again = a.allocate(3)
    assert a.drain_allocated() == first + again
    assert a.drain_allocated() == []
