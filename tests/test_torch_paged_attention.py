"""The port's paged-decode attention and its host-side page bookkeeping.

The plain PyTorch version (``paged_attn_reference``) is held against the
JAX package's XLA reference and its Pallas kernel in interpret mode on
the same numpy inputs. The CUDA kernel itself runs only on the card: it
is compiled and compared with the plain version by ``chip_smoke.py``.
Here the wrapper's argument checks, its CPU dispatch, the build command
and the C interface are checked, along with the block allocator, the
prefix cache and the scheduler.

torch and the port are imported inside fixtures, so collecting this
file costs nothing.
"""

import re
import types

import numpy as np
import pytest

# fp32: the TPU kernel multiplies by 1/sqrt(hd) where the references
# divide by sqrt(hd), and the sums run in other orders
TOL = 1e-5


@pytest.fixture(scope="module")
def pa():
    import torch
    from paddle_tpu_torch.kernels import paged_attention
    return types.SimpleNamespace(torch=torch, mod=paged_attention)


def _random_paged(seed=0, B=3, kvh=2, G=2, hd=16, n_blocks=9, bs=8,
                  max_blocks=4, lens=(13, 5, 16)):
    """Random pool and tables with ragged lengths (mid-page, tiny, on a
    page boundary); table entries past a row's pages are the NULL page."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, kvh, G, hd).astype(np.float32) * 0.5
    kp = rng.randn(n_blocks, bs, kvh, hd).astype(np.float32) * 0.5
    vp = rng.randn(n_blocks, bs, kvh, hd).astype(np.float32) * 0.5
    lens = np.asarray(lens, np.int32)
    table = np.zeros((B, max_blocks), np.int32)
    free = list(rng.permutation(np.arange(1, n_blocks)))  # page 0 = NULL
    for b in range(B):
        for j in range(-(-int(lens[b]) // bs)):
            table[b, j] = free.pop(0)
    return q, kp, vp, table, lens


def _port(pa, arrays):
    return [pa.torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("hd", [16, 32])
def test_reference_matches_jax_reference(pa, hd):
    import jax.numpy as jnp
    from paddle_tpu.kernels.paged_attention import _paged_attn_reference
    arrays = _random_paged(seed=hd, hd=hd)
    want = np.asarray(_paged_attn_reference(*map(jnp.asarray, arrays)))
    got = pa.mod.paged_attn_reference(*_port(pa, arrays)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def empty_row_case():
    """Ragged rows plus one all-NULL row of length 0, and the TPU
    kernel's output on them in interpret mode (run once)."""
    import jax.numpy as jnp
    from paddle_tpu.kernels.paged_attention import paged_attention_pallas
    arrays = _random_paged(seed=3, B=3, lens=(11, 0, 24))
    want = np.asarray(paged_attention_pallas(*map(jnp.asarray, arrays),
                                             interpret=True))
    return arrays, want


def test_reference_matches_interpret_kernel_with_empty_row(pa,
                                                           empty_row_case):
    """The TPU kernel run in interpret mode, on ragged rows plus one
    all-NULL row of length 0, which both give zeros."""
    arrays, want = empty_row_case
    assert not arrays[3][1].any()            # the empty row is all NULL
    got = pa.mod.paged_attn_reference(*_port(pa, arrays)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got[1], 0.0)


# The split pass of the CUDA kernels, merged: fp32 sums by splits and
# the kernels' multiplication by 1/sqrt(hd), against references that
# divide and sum in one pass
SPLIT_TOL = 2e-5


@pytest.mark.parametrize("split_keys", [16, 64])
def test_decode_partials_merge_to_the_references(pa, split_keys):
    """decode_attn_partials merged by merge_softmax_partials, on rows
    that end on a split boundary (64 keys), one key past it (65), at
    length 0 and at the table's full width (136): equal to
    paged_attn_reference, and to the JAX ``_paged_attn_reference`` on
    every row of nonzero length (it gives NaN at length 0). At 16 keys
    the last split of the full row is a partial one."""
    import jax.numpy as jnp
    from paddle_tpu.kernels.paged_attention import _paged_attn_reference
    arrays = _random_paged(seed=11, B=4, n_blocks=36, max_blocks=17,
                           lens=(64, 65, 0, 136))
    args = _port(pa, arrays)
    m, l, acc = pa.mod.decode_attn_partials(*args, split_keys=split_keys)
    assert m.shape[0] == -(-136 // split_keys)
    got = pa.mod.merge_softmax_partials(m, l, acc).numpy()
    want = pa.mod.paged_attn_reference(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SPLIT_TOL)
    np.testing.assert_array_equal(got[2], 0.0)
    jax_want = np.asarray(_paged_attn_reference(*map(jnp.asarray, arrays)))
    live = [0, 1, 3]
    np.testing.assert_allclose(got[live], jax_want[live], rtol=0,
                               atol=SPLIT_TOL)
    if split_keys == pa.mod.DECODE_SPLIT_KEYS:
        assert pa.mod.decode_splits(17, 8) == m.shape[0]
        assert pa.mod.decode_workspace_floats(4, 2, 2, 16, 17, 8) \
            == m.shape[0] * 4 * 2 * 2 * (16 + 2)


def test_decode_partials_match_interpret_kernel_with_empty_row(
        pa, empty_row_case):
    """The interpret-mode TPU kernel's rows (11 keys, 0, and 24 on a
    boundary of 8-key splits): the merged partials equal its output,
    zeros included, and the empty row's splits are the empty state."""
    arrays, want = empty_row_case
    m, l, acc = pa.mod.decode_attn_partials(*_port(pa, arrays),
                                            split_keys=8)
    got = pa.mod.merge_softmax_partials(m, l, acc).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SPLIT_TOL)
    np.testing.assert_array_equal(got[1], 0.0)
    assert bool((m[:, 1] == -1e30).all() & (l[:, 1] == 0).all()
                & (acc[:, 1] == 0).all())


def test_null_page_contents_never_reach_an_output(pa):
    """Inactive rows and finished-mid-chunk rows scribble on page 0; no
    row reads it within its length, so nothing changes."""
    q, kp, vp, table, lens = _port(pa, _random_paged(seed=7))
    ref = pa.mod.paged_attn_reference(q, kp, vp, table, lens)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[0] = 1e3
    vp2[0] = -1e3
    out = pa.mod.paged_attn_reference(q, kp2, vp2, table, lens)
    assert pa.torch.equal(out, ref)


def test_bf16_inputs_give_fp32_output(pa):
    torch = pa.torch
    q, kp, vp, table, lens = _port(pa, _random_paged(seed=9))
    out = pa.mod.paged_attn_reference(q.bfloat16(), kp.bfloat16(),
                                      vp.bfloat16(), table, lens)
    ref = pa.mod.paged_attn_reference(q, kp, vp, table, lens)
    assert out.dtype == torch.float32
    assert (out - ref).abs().max() < 2e-2


def test_wrapper_runs_plain_version_on_cpu_and_counts_nothing(pa):
    args = _port(pa, _random_paged(seed=5))
    before = dict(pa.mod.launch_counts)
    out = pa.mod.paged_decode_attention(*args)
    assert pa.torch.equal(out, pa.mod.paged_attn_reference(*args))
    assert dict(pa.mod.launch_counts) == before


def test_wrapper_refuses_devices_without_a_kernel(pa):
    args = [a.to("meta") for a in _port(pa, _random_paged(seed=5))]
    with pytest.raises(ValueError, match="no kernel"):
        pa.mod.paged_decode_attention(*args)


def test_kernel_args_accepts_the_engine_shapes(pa):
    torch = pa.torch
    q = torch.zeros(4, 8, 4, 128, dtype=torch.bfloat16)
    kp = torch.zeros(20, 16, 8, 128, dtype=torch.bfloat16)
    table = torch.zeros(4, 5, dtype=torch.int32)
    lens = torch.zeros(4, dtype=torch.int32)
    pa.mod.check_kernel_args(q, kp, kp.clone(), table, lens)


@pytest.mark.parametrize("case", [
    "hd", "group", "block_size", "dtype", "mixed_dtype", "table_dtype",
    "pool_shape", "contiguity", "rows"])
def test_kernel_args_rejects(pa, case):
    torch = pa.torch
    q = torch.zeros(2, 2, 2, 16)
    kp = torch.zeros(6, 8, 2, 16)
    vp = torch.zeros(6, 8, 2, 16)
    table = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    if case == "hd":
        q, kp, vp = (torch.zeros(*a.shape[:-1], 48) for a in (q, kp, vp))
    elif case == "group":
        q = torch.zeros(2, 2, 9, 16)
    elif case == "block_size":
        kp = vp = torch.zeros(6, 12, 2, 16)
    elif case == "dtype":
        q, kp, vp = (a.double() for a in (q, kp, vp))
    elif case == "mixed_dtype":
        kp = kp.bfloat16()
    elif case == "table_dtype":
        table = table.long()
    elif case == "pool_shape":
        vp = torch.zeros(6, 8, 2, 32)
    elif case == "contiguity":
        q = torch.zeros(2, 2, 16, 2).transpose(2, 3)
    elif case == "rows":
        lens = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        pa.mod.check_kernel_args(q, kp, vp, table, lens)


def test_build_targets_hopper_into_ignored_build_dir(monkeypatch):
    from paddle_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    out = _build.library_path("paged_decode")
    cmd = _build.nvcc_command("paged_decode", out)
    assert cmd[0] == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-O3" in cmd and "-fPIC" in cmd
    assert cmd[-1].endswith("csrc/paged_decode.cu")
    root = _build.BUILD_DIR.parents[1]
    assert out.parent == root / "build" / "kernels"
    ignored = (root / ".gitignore").read_text().split()
    assert "build/" in ignored


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from paddle_tpu_torch.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_c_interface_matches_the_ctypes_binding(pa):
    """The source cannot be compiled here, so check that its exported
    function takes as many arguments as the binding declares."""
    from paddle_tpu_torch.kernels import _build
    src = (_build.CSRC / "paged_decode.cu").read_text()
    m = re.search(r'extern "C" int paged_decode_attention\(([^)]*)\)', src)
    assert m, "exported C function not found"
    n_params = len(m.group(1).split(","))
    lib = types.SimpleNamespace(
        paged_decode_attention=types.SimpleNamespace())
    pa.mod._bind(lib)
    assert len(lib.paged_decode_attention.argtypes) == n_params == 17
    assert "sm_90a" in src and "_paged_kernel" in src


# -- block allocator ----------------------------------------------------------

def _alloc(n=9):
    from paddle_tpu_torch.inference.paged_cache import BlockAllocator
    return BlockAllocator(n)


def test_allocator_never_hands_out_null_page():
    a = _alloc(9)
    pages = a.allocate(a.capacity)
    assert pages is not None and 0 not in pages
    assert sorted(pages) == list(range(1, 9))


def test_allocator_all_or_nothing():
    a = _alloc(9)
    assert a.allocate(9) is None
    assert a.num_free == 8
    first = a.allocate(6)
    assert a.allocate(3) is None
    assert a.num_free == 2
    a.free(first)
    assert a.num_free == 8


def test_allocator_double_and_foreign_free_raise():
    a = _alloc(5)
    pages = a.allocate(2)
    a.free(pages)
    with pytest.raises(ValueError):
        a.free(pages)
    with pytest.raises(ValueError):
        a.free([0])


def test_allocator_fragmentation_interleaved_alloc_free():
    a = _alloc(17)
    rows = [a.allocate(4) for _ in range(4)]
    a.free(rows[0])
    a.free(rows[2])
    again = a.allocate(8)
    assert sorted(again) == sorted(rows[0] + rows[2])
    assert a.num_free == 0
    assert a.stats() == {"capacity": 16, "used": 16, "free": 0,
                         "high_watermark": 16, "total_allocated": 24,
                         "total_freed": 8}
    assert a.conservation_ok


def test_allocator_refcounts_shared_pages():
    a = _alloc(5)
    (p,) = a.allocate(1)
    a.incref(p)
    with pytest.raises(ValueError, match="live references"):
        a.free([p])
    a.decref(p)
    assert a.refcount(p) == 1
    a.decref(p)
    assert a.refcount(p) == 0 and a.num_free == 4
    with pytest.raises(ValueError):
        a.incref(p)


def test_allocator_rejects_degenerate_pool():
    with pytest.raises(ValueError):
        _alloc(1)


# -- prefix cache -------------------------------------------------------------

def _cache(n=17, bs=4):
    from paddle_tpu_torch.inference.prefix_cache import PrefixCache
    a = _alloc(n)
    return a, PrefixCache(a, bs)


def test_prefix_cache_shares_full_pages_and_copies_partial():
    a, c = _cache()
    toks = list(range(10, 20))                # 2 full pages + 2 tokens
    pages = a.allocate(3)
    assert c.insert(toks, pages) == 3
    for p in pages:                           # the row lets go
        a.decref(p)
    assert all(a.refcount(p) == 1 for p in pages)
    m = c.match(toks[:9] + [99, 98], limit=10)
    assert m.pages == pages[:2] and m.cow_src == pages[2]
    assert m.cow_len == 1 and m.cached_len == 9
    assert a.refcount(pages[0]) == 2 and a.refcount(pages[2]) == 2
    c.release_cow(m)
    c.release(m)
    assert all(a.refcount(p) == 1 for p in pages)
    assert c.stats()["hits"] == 1 and c.hit_rate == 1.0


def test_prefix_cache_limit_keeps_a_token_uncached():
    a, c = _cache()
    toks = list(range(8))
    pages = a.allocate(2)
    c.insert(toks, pages)
    m = c.match(toks, limit=7)
    assert m.pages == pages[:1] and m.cached_len == 7
    c.release(m)


def test_prefix_cache_evicts_lru_unreferenced_leaves_first():
    a, c = _cache()
    old, new = a.allocate(1), a.allocate(1)
    c.insert([1, 2, 3, 4], old)
    c.insert([5, 6, 7, 8], new)
    for p in old + new:
        a.decref(p)
    m = c.match([5, 6, 7, 8, 9], limit=4)     # pins and touches `new`
    assert c.evict(2) == 1                    # only `old` is evictable
    assert a.refcount(old[0]) == 0 and a.refcount(new[0]) == 2
    c.release(m)
    assert c.evict(5) == 1 and len(c) == 0
    assert a.num_free == a.capacity


# -- scheduler, metrics, traces ----------------------------------------------

def test_scheduler_orders_by_priority_then_arrival_and_keeps_stamp():
    from paddle_tpu_torch.inference.scheduler import RequestScheduler
    s = RequestScheduler()
    reqs = [types.SimpleNamespace(priority=p, ids=np.zeros(3))
            for p in (0, 1, 0, 1)]
    for r in reqs:
        s.add(r)
    assert s.pending_tokens() == 12
    order = [s.pop() for _ in range(4)]
    assert order == [reqs[1], reqs[3], reqs[0], reqs[2]]
    s.add(reqs[2])                            # re-queued after preemption
    s.add(types.SimpleNamespace(priority=0, ids=np.zeros(1)))
    assert s.peek() is reqs[2] and reqs[2]._sched_seq == 2


def test_step_budget_forces_decode_and_funds_whole_items():
    from paddle_tpu_torch.inference.scheduler import StepBudget
    b = StepBudget(10)
    assert b.take(8, force=True) and b.remaining == 2
    assert not b.take(4) and b.used == 8
    assert b.take(6, force=True) and b.used == 14 and b.remaining == 0


def test_metrics_and_trace_derive_latencies():
    from paddle_tpu_torch.observability import MetricsRegistry, RequestTrace
    r = MetricsRegistry()
    r.counter("c").inc(2)
    r.gauge("g", fn=lambda: 7)
    h = r.histogram("h", buckets=(1.0, 2.0))
    for v in (0.5, 1.5, 3.0):
        h.observe(v)
    snap = r.snapshot()
    assert snap["counters"]["c"] == 2 and snap["gauges"]["g"] == 7
    assert snap["histograms"]["h"]["buckets"] == {"1": 1, "2": 2,
                                                  "+Inf": 3}
    with pytest.raises(TypeError):
        r.gauge("c")
    tr = RequestTrace(t=0.0)
    tr.mark("queued", t=1.0)
    tr.mark("admitted", t=3.0)
    tr.mark("first_token", t=4.0)
    tr.mark("decode_chunk", t=5.0, n_tokens=3)
    tr.mark("retired", t=6.0)
    assert tr.ttft == 4.0 and tr.queue_wait == 2.0
    assert tr.terminal == "retired" and tr.served_tokens == 3
    assert tr.mark_once("first_token") is None and tr.is_monotone()
