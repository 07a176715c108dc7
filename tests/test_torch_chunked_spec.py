"""The port's serving features against the JAX engine: int8 paged KV,
chunked prefill and self-speculative decoding in ``DecodeEngine``.

The same weights (a seeded JAX ``debug`` model exported through
``from_jax_state_dict``) and the same prompts go through both engines in
fp32 on the CPU, where the port's decode attention is its plain version
(the CUDA kernels are checked on the card by ``chip_smoke.py``): greedy
tokens must be identical and the step accounting equal. The port's own
invariants are held too: int8 tokens equal fp tokens on this workload,
chunked tokens equal monolithic ones, speculative tokens equal plain
greedy ones, and a row preempted mid-prefill resumes losslessly. The
chunk-funding policy and the drafter are checked on their own.

Each JAX engine run is made once per module and configuration; torch,
the port and JAX are imported inside fixtures.
"""

import types

import numpy as np
import pytest

ENGINE = dict(capacity=4, s_max=96, chunk=4, block_size=8)
CONFIGS = {
    "int8": dict(kv_dtype="int8"),
    "chunked": dict(chunked_prefill=True),
    "chunked-int8": dict(chunked_prefill=True, kv_dtype="int8"),
    "spec-chunked": dict(spec_decode=True, chunked_prefill=True),
}


def _workload():
    """Single- and multi-chunk prompts, one whose last chunk is partial,
    a repeating prompt (drafts that verify), and a pair sharing a
    20-token prefix (2 full pages of 8 and a partial one, so the second
    copies a page and its scales); the second arrives after the first
    has retired."""
    rng = np.random.RandomState(21)
    tok = lambda n: rng.randint(1, 128, (n,)).astype(np.int32)
    shared = tok(20)
    wave1 = [(tok(8), 8), (tok(37), 8), (tok(7), 10), (tok(29), 8),
             (np.tile(tok(6), 4), 12),
             (np.concatenate([shared, tok(3)]), 6)]
    wave2 = [(np.concatenate([shared, tok(5)]), 6)]
    return [wave1, wave2]


def _drive(eng, make_request, waves, iters=400):
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


@pytest.fixture(scope="module")
def ref():
    import torch
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.convert import from_jax_state_dict
    from paddle_tpu_torch.inference import serving
    paddle.seed(0)
    jm = LlamaForCausalLM("debug")
    jm.eval()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    pm = from_jax_state_dict(state, "debug", device="cpu")
    plain = serving.DecodeEngine(pm, **ENGINE)
    want = _drive(plain, serving._Request, _workload())
    return types.SimpleNamespace(jm=jm, pm=pm, torch=torch,
                                 serving=serving, plain=want)


def test_engine_options_are_validated(ref):
    DecodeEngine = ref.serving.DecodeEngine
    with pytest.raises(ValueError, match="kv_dtype"):
        DecodeEngine(ref.pm, kv_dtype="fp8")
    with pytest.raises(ValueError, match="spec_max_draft"):
        DecodeEngine(ref.pm, spec_decode=True, spec_max_draft=0)
    with pytest.raises(ValueError, match="prefill_chunk"):
        DecodeEngine(ref.pm, chunked_prefill=True, prefill_chunk=-1)
    eng = DecodeEngine(ref.pm, capacity=3, chunk=4, block_size=8,
                       chunked_prefill=True, spec_decode=True,
                       kv_dtype="int8")
    assert eng.step_budget == 3 * 4 + 8
    assert eng.stats()["spec"]["proposed"] == 0


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_run(request, ref):
    """The JAX engine's outputs and stats under one configuration."""
    from paddle_tpu.inference.serving import DecodeEngine, _Request
    eng = DecodeEngine(ref.jm, **ENGINE, **CONFIGS[request.param])
    outs = _drive(eng, _Request, _workload())
    return request.param, outs, eng.stats()


def test_engine_matches_jax_engine(ref, jax_run):
    name, want_outs, w = jax_run
    eng = ref.serving.DecodeEngine(ref.pm, **ENGINE, **CONFIGS[name])
    outs = _drive(eng, ref.serving._Request, _workload())
    for got, want in zip(outs, want_outs):
        np.testing.assert_array_equal(got, want)
    s = eng.stats()
    assert s["prefix_hit_tokens"] == w["prefix_hit_tokens"] == 20
    for key in ("admitted", "retired", "failed", "preempted",
                "device_steps", "device_calls", "prefills",
                "prefill_chunks", "pool"):
        assert s[key] == w[key], key
    if "spec" in w:
        assert s["spec"] == w["spec"]
    # the port's own invariant: the feature changes no token
    for got, plain in zip(outs, ref.plain):
        np.testing.assert_array_equal(got, plain)


def test_chunk_and_step_accounting(ref):
    """One chunk per page-sized window of prompt; first tokens after
    the last chunk; the budget histogram sees every step; the prefill
    backlog counts queued prompts and unprefilled remainders."""
    eng = ref.serving.DecodeEngine(ref.pm, capacity=1, s_max=96, chunk=4,
                                   block_size=8, chunked_prefill=True,
                                   step_budget=8)
    assert eng.prefill_chunk == 8 and eng.step_budget == 8
    rng = np.random.RandomState(24)
    p1, p2 = (rng.randint(1, 128, (n,)).astype(np.int32) for n in (24, 16))
    r1, r2 = eng.submit(p1, 4), eng.submit(p2, 4)
    eng.admit([])                       # r1 takes the slot, r2 waits
    assert eng.stats()["prefill_backlog"] == 40
    assert eng.metrics.gauge("engine_prefill_backlog_tokens").value == 40
    row = eng._rows[0]
    for step in range(1, 4):
        eng.decode_once()               # one 8-token chunk per step
        assert eng.stats()["prefill_backlog"] == 40 - 8 * step
        assert ("pf_seq" in row) == (step < 3)
        if step < 3:
            assert row["pf_pos"] == 8 * step and not eng._tables[0].any()
    _drive(eng, ref.serving._Request, [[]])
    s = eng.stats()
    assert s["prefill_chunks"] == 3 + 2 and s["prefill_backlog"] == 0
    assert eng.metrics.histogram("engine_step_budget_used").count >= 5
    for r in (r1, r2):
        tr = r.trace
        assert tr.first("first_token") >= tr.last("prefill_chunk")
        assert tr.count("first_token") == 1 and tr.terminal == "retired"
    plain = ref.serving.DecodeEngine(ref.pm, capacity=1, s_max=96,
                                     chunk=4, block_size=8)
    want = _drive(plain, ref.serving._Request,
                  [[(p1, 4), (p2, 4)]])
    np.testing.assert_array_equal(r1.wait(), want[0])
    np.testing.assert_array_equal(r2.wait(), want[1])


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_preempt_mid_prefill_resumes_losslessly(ref, kv_dtype):
    """A high-priority arrival evicts a row that is still mid chunked
    prefill; the victim resumes through re-admission and emits the
    tokens an ample engine gives."""
    rng = np.random.RandomState(25)
    p_lo = rng.randint(1, 128, (20,)).astype(np.int32)
    p_hi = rng.randint(1, 128, (17,)).astype(np.int32)
    ample = ref.serving.DecodeEngine(ref.pm, capacity=2, s_max=64,
                                     chunk=4, block_size=8)
    want = _drive(ample, ref.serving._Request,
                  [[(p_lo, 4), (p_hi, 4)]])
    eng = ref.serving.DecodeEngine(ref.pm, capacity=2, s_max=64, chunk=4,
                                   block_size=8, n_blocks=4,
                                   chunked_prefill=True, step_budget=8,
                                   kv_dtype=kv_dtype)
    lo = eng.submit(p_lo, 4)
    eng.admit([])
    eng.decode_once()
    row = next(r for r in eng._rows if r is not None)
    assert "pf_seq" in row and row["pf_pos"] == 8
    hi = eng.submit(p_hi, 4, priority=5)    # needs all 3 usable pages
    _drive(eng, ref.serving._Request, [[]])
    s = eng.stats()
    assert s["preempted"] >= 1 and s["failed"] == 0
    np.testing.assert_array_equal(lo.wait(), want[0])
    np.testing.assert_array_equal(hi.wait(), want[1])
    assert eng._alloc.conservation_ok


def test_spec_under_preemption_and_rollback(ref):
    """A pool small enough that verify growth preempts rows: resumed
    rows still emit plain greedy tokens, drafts were accepted, and after
    reject-heavy rollbacks every page is accounted for."""
    rng = np.random.RandomState(9)
    prompts = [np.tile(rng.randint(1, 128, (8,)).astype(np.int32), 3)
               for _ in range(3)]
    wave = [[(p, 16) for p in prompts]]
    plain = ref.serving.DecodeEngine(ref.pm, capacity=3, s_max=64,
                                     chunk=4, block_size=8)
    want = _drive(plain, ref.serving._Request, wave)
    eng = ref.serving.DecodeEngine(ref.pm, capacity=3, s_max=64, chunk=4,
                                   block_size=8, n_blocks=13,
                                   spec_decode=True, kv_dtype="int8")
    got = _drive(eng, ref.serving._Request, wave, iters=2000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    s = eng.stats()
    assert s["preempted"] > 0 and s["spec"]["accepted"] > 0
    assert s["spec"]["verify_steps"] == s["device_steps"]
    a = eng._alloc
    assert a.total_allocated - a.total_freed == a.in_use
    assert eng.metrics.gauge("engine_spec_accept_rate").value == \
        s["spec"]["accept_rate"]


# -- the chunk-funding policy and the drafter ---------------------------------

def _req(seq, priority=0):
    return types.SimpleNamespace(_sched_seq=seq, priority=priority)


@pytest.mark.parametrize("case", ["head_of_line", "priority", "several",
                                  "none"])
def test_plan_prefill(case):
    from paddle_tpu_torch.inference.scheduler import (RequestScheduler,
                                                      StepBudget)
    s = RequestScheduler()
    a, b, c = _req(0), _req(1), _req(2)
    if case == "head_of_line":
        # b does not fit and c may not slide in ahead of it
        budget = StepBudget(10)
        assert s.plan_prefill(budget, [(a, 8), (b, 8), (c, 1)]) == [(a, 8)]
        assert budget.used == 8
    elif case == "priority":
        hi = _req(3, priority=5)
        assert s.plan_prefill(StepBudget(8), [(a, 8), (hi, 8)]) == \
            [(hi, 8)]
    elif case == "several":
        funded = s.plan_prefill(StepBudget(20), [(c, 4), (a, 8), (b, 8)])
        assert funded == [(a, 8), (b, 8), (c, 4)]
    else:
        budget = StepBudget(8)
        budget.take(8, force=True)          # decode lanes took it all
        assert s.plan_prefill(budget, [(a, 1)]) == []


def test_ngram_drafter_matches_the_reference():
    from paddle_tpu.inference.spec_decode import NgramDrafter as JDrafter
    from paddle_tpu_torch.inference.spec_decode import NgramDrafter
    rng = np.random.RandomState(7)
    contexts = [np.asarray([5, 6, 7, 5, 6, 7, 5, 6], np.int32),
                np.asarray([1, 2], np.int32), np.asarray([3], np.int32)]
    contexts += [rng.randint(1, 6, (n,)).astype(np.int32)
                 for n in (4, 9, 17, 33)]
    for kw in (dict(), dict(max_draft=2, max_ngram=2),
               dict(max_draft=6, min_ngram=2)):
        mine, theirs = NgramDrafter(**kw), JDrafter(**kw)
        assert repr(mine) == repr(theirs)
        for ctx in contexts:
            for limit in (None, 0, 1, 3):
                np.testing.assert_array_equal(
                    mine.propose(ctx, limit=limit),
                    theirs.propose(ctx, limit=limit))
    with pytest.raises(ValueError):
        NgramDrafter(min_ngram=3, max_ngram=2)
