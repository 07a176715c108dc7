"""Continuous-batching decode engine over a paged KV cache.

Counterpart of the paged, single-device path of
``paddle_tpu.inference.serving.DecodeEngine``. The KV cache is a
``[L, n_blocks, block_size, kvh, hd]`` block pool with a per-row block
table and a host-side free list (:class:`BlockAllocator`). Rows own
ragged lengths that start at their own position 0, so admission needs
no global fill position, rows retire by freeing their pages, and the
engine never resets under sustained traffic. A radix prefix cache
shares the pages of common prompt prefixes, with copy-on-write for a
partly shared page, and a priority scheduler admits requests, evicting
cached pages and preempting lower-priority rows when the pool runs dry.
Greedy outputs equal the reference engine's on the same weights.

Options, each off by default (outputs then stay as without it):

- ``kv_dtype="int8"``: the pools hold int8 codes with one float32 scale
  per (layer, page, kv head) beside them; writes quantize with a
  running-max scale and the decode attention dequantizes inside the
  int8 kernel.
- ``chunked_prefill``: admission takes the slot and the pages but
  defers the prompt forward; each step funds ``prefill_chunk``-token
  chunks out of a ``step_budget`` after the decode lanes have claimed
  theirs, so a long prompt feeds in beside running decodes.
- ``spec_decode``: every decode-ready row drafts up to
  ``spec_max_draft`` tokens from its own history (:class:`NgramDrafter`)
  and verifies them in one position-offset prefill, accepting the
  longest prefix that greedy decoding would have produced.
- ``mesh=`` (a ``sharding.make_tp_mesh`` mesh): tensor parallelism over
  the mesh's ``tp`` ranks. The pools split over kv heads and the
  weights Megatron style, one shard per rank on its device; the
  allocator, tables and scheduler stay on the host, once. A mesh engine
  runs every step that holds a verify window or a prefill chunk as ONE
  mixed step (:meth:`DecodeEngine._decode_once_mixed`, the single
  ``mixed_paged_step`` whose attention is ``kernels.paged_attention.
  mixed_paged_attention``); plain decode keeps the decode chunk. A
  one-device mesh (``make_tp_mesh(1)``) gives the tokens of
  ``mesh=None`` through the mixed path.

What differs from the reference: its per-bucket compiled programs are
plain calls here, and where it donates the pools (and int8 scales) to
those programs the port updates them in place. Every attention read of
a decode step goes through ``kernels.paged_attention.
paged_decode_attention``. Where the reference lowers its programs
through ``shard_map`` over a mesh, one controller here drives every
rank (``inference.sharding``).
"""

from __future__ import annotations

import logging
import threading

import numpy as np
import torch

from ..kernels.paged_attention import (KV_SCALE_EPS, mixed_paged_attention,
                                       paged_decode_attention)
from ..models import llama as _llama
from ..observability import MetricsRegistry, RequestTrace, now as _now
from ..utils.log import get_logger, log_event, log_kv
from .paged_cache import BlockAllocator
from .prefix_cache import PrefixCache
from .scheduler import RequestScheduler, StepBudget
from .sharding import (pool_specs, shard, shard_weights,
                       validate_mesh_config)
from .spec_decode import NgramDrafter

__all__ = ["DecodeEngine"]

_log = get_logger("paddle_tpu_torch.inference.engine")


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md "
        f"Queue 1, item {item})")


class DecodeEngine:
    """Paged continuous batching for a :class:`LlamaForCausalLM`.

    Drive it with :meth:`submit` (or :meth:`admit` with a list of
    requests) and :meth:`decode_once`; each ``decode_once`` runs one
    engine step (``chunk`` greedy decode steps for every decode-ready
    row, one verify step per row with ``spec_decode``, or one mixed
    step on a mesh), retires finished rows and returns the number still
    alive. The engine runs on the model's device, or on its mesh's;
    ``device_steps`` counts executed decode, verify and mixed steps. The
    options are described in the module docstring."""

    def __init__(self, model, capacity=4, s_max=256, chunk=8, pad_id=0,
                 paged=True, block_size=16, n_blocks=None,
                 prefix_cache=True, chunked_prefill=False,
                 prefill_chunk=None, step_budget=None,
                 spec_decode=False, spec_max_draft=4, kv_dtype="fp",
                 mesh=None, tp_axis="tp", seq_axis="seq"):
        if mesh is not None and not paged:
            raise ValueError("mesh= requires the paged engine (the block "
                             "pools are what shards)")
        if not paged:
            raise _not_ported("the contiguous KV cache (paged=False)", 2)
        self.mesh = mesh
        self.tp_axis = tp_axis
        self.seq_axis = seq_axis
        self._tp = self._seq = 1
        if mesh is not None:
            if tp_axis not in mesh.axis_names:
                raise ValueError(f"mesh axes {mesh.axis_names} have no "
                                 f"tp_axis={tp_axis!r}")
            self._tp = int(mesh.shape[tp_axis])
            if seq_axis in mesh.axis_names:
                self._seq = int(mesh.shape[seq_axis])
            if self._seq > 1:
                raise _not_ported(
                    f"a mesh whose {seq_axis!r} extent is above 1 (the "
                    f"page-sharded 2-D mesh)", 4)
        if kv_dtype not in ("fp", "int8"):
            raise ValueError(f"kv_dtype={kv_dtype!r} (want 'fp' or "
                             f"'int8')")
        self.model = model
        self.capacity = int(capacity)
        self.s_max = int(s_max)
        self.chunk = int(chunk)
        self.pad_id = int(pad_id)
        self.block_size = int(block_size)
        self._prefix_on = bool(prefix_cache)
        # chunked prefill: chunks of ``prefill_chunk`` prompt tokens
        # (default one page) under a per-step token budget (default
        # every decode lane plus one chunk)
        self.chunked_prefill = bool(chunked_prefill)
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk \
            else self.block_size
        if self.prefill_chunk <= 0:
            raise ValueError(f"prefill_chunk={prefill_chunk!r}")
        self.step_budget = int(step_budget) if step_budget \
            else self.capacity * self.chunk + self.prefill_chunk
        self.spec_decode = bool(spec_decode)
        self.spec_max_draft = int(spec_max_draft)
        if self.spec_decode and self.spec_max_draft < 1:
            raise ValueError(f"spec_max_draft={spec_max_draft}")
        self._drafter = NgramDrafter(max_draft=self.spec_max_draft) \
            if self.spec_decode else None
        self.kv_dtype = kv_dtype
        self._kv_q = kv_dtype == "int8"
        # table width covers the overflow writes of rows that finish
        # mid-chunk (their tail lands on the NULL page)
        self._max_blocks = -(-(self.s_max + self.chunk) // self.block_size)
        if n_blocks is None:
            # full occupancy never starves: every row can grow to s_max,
            # plus the reserved NULL page
            n_blocks = self.capacity * -(-self.s_max // self.block_size) + 1
        self.n_blocks = int(n_blocks)
        self._sched = RequestScheduler()
        cfg = model.config
        self._cfg = cfg
        self._L = cfg.num_hidden_layers
        self._kvh = cfg.num_key_value_heads
        self._hd = cfg.head_dim
        self.device = model.embed_tokens.device
        self._cache_dtype = model.embed_tokens.dtype
        self._placed = None
        if mesh is not None:
            validate_mesh_config(cfg, self._tp, self._seq,
                                 n_blocks=self.n_blocks)
            # the tp ranks' devices; rank 0's holds the replicated
            # weights, the host data and the residual stream
            self._devices = list(mesh.devices[:self._tp])
            self.device = self._devices[0]
        self.device_steps = 0
        self.prefills = 0
        self.resets = 0                 # construction counts as 1
        self.metrics = MetricsRegistry()
        self._init_metrics()
        self._reset()

    def _init_metrics(self):
        r = self.metrics
        self._c_admitted = r.counter(
            "engine_admitted_total", "requests admitted into a slot")
        self._c_retired = r.counter(
            "engine_retired_total", "requests finished cleanly")
        self._c_failed = r.counter(
            "engine_failed_total", "requests failed (admission or growth)")
        self._c_preempted = r.counter(
            "engine_preempted_total", "rows evicted for recompute-resume")
        self._c_prefix_hit = r.counter(
            "engine_prefix_hit_tokens_total",
            "prompt tokens served from the prefix cache")
        self._c_steps = r.counter(
            "engine_device_steps_total", "decode steps executed")
        self._c_prefills = r.counter(
            "engine_prefills_total", "admission prefills run")
        self._c_device_calls = r.counter(
            "engine_device_calls_total",
            "device calls (prefill, prefill chunk, decode chunk, verify, "
            "copy-on-write)")
        self._c_prefill_chunks = r.counter(
            "engine_prefill_chunks_total",
            "prefill chunks scheduled into decode steps")
        self._h_budget = r.histogram(
            "engine_step_budget_used",
            "tokens funded per engine step (decode lanes + prefill "
            "chunks)",
            buckets=tuple(float(2 ** i) for i in range(14)))
        self._h_ttft = r.histogram(
            "engine_ttft_seconds", "arrival to first emitted token")
        self._h_tpot = r.histogram(
            "engine_tpot_seconds", "per-output-token decode latency")
        self._h_queue_wait = r.histogram(
            "engine_queue_wait_seconds",
            "queued->admitted wait summed over preemption stints")
        self._h_chunk = r.histogram(
            "engine_chunk_seconds", "decode chunk wall time")
        self._g_occupancy = r.gauge(
            "engine_batch_occupancy", "rows occupied by the last chunk")
        r.gauge("engine_backlog", "scheduler backlog depth",
                fn=lambda: self.backlog)
        r.gauge("engine_prefill_backlog_tokens",
                "queued + admitted prompt tokens not yet prefilled",
                fn=lambda: self.prefill_backlog)
        r.gauge("engine_pool_free", "free pages in the block pool",
                fn=lambda: self._alloc.num_free)
        r.gauge("allocator_in_use", "pages with live references",
                fn=lambda: self._alloc.in_use)
        r.gauge("engine_pool_high_watermark",
                "max pages ever in use at once",
                fn=lambda: self._alloc.high_watermark)
        if self._prefix_on:
            r.gauge("engine_prefix_hit_rate",
                    "fraction of admissions matching any cached prefix",
                    fn=lambda: (self._cache.hit_rate
                                if self._cache is not None else 0.0))
        if self.spec_decode:
            # accepted counts the tokens beyond the one a plain step
            # gives: accepted / proposed is the draft survival rate
            self._c_spec_proposed = r.counter(
                "engine_spec_proposed_total",
                "draft tokens submitted to verify steps")
            self._c_spec_accepted = r.counter(
                "engine_spec_accepted_total",
                "draft tokens accepted (emitted beyond the per-step "
                "baseline)")
            self._h_spec_accept = r.histogram(
                "engine_spec_accept_len",
                "tokens emitted per verify step (1 = every draft "
                "rejected)",
                buckets=tuple(float(i) for i in
                              range(1, self.spec_max_draft + 2)))
            r.gauge("engine_spec_accept_rate",
                    "accepted/proposed draft token fraction",
                    fn=lambda: (self._c_spec_accepted.value
                                / self._c_spec_proposed.value
                                if self._c_spec_proposed.value else 0.0))

    def _reset(self):
        self.resets += 1
        B = self.capacity
        shape = (self._L, self.n_blocks, self.block_size, self._kvh,
                 self._hd)
        self._kp = torch.zeros(shape, device=self.device,
                               dtype=torch.int8 if self._kv_q
                               else self._cache_dtype)
        self._vp = torch.zeros_like(self._kp)
        if self._kv_q:
            self._kscale = torch.full((self._L, self.n_blocks, self._kvh),
                                      KV_SCALE_EPS, dtype=torch.float32,
                                      device=self.device)
            self._vscale = torch.full_like(self._kscale, KV_SCALE_EPS)
        if self.mesh is not None:
            # one kv-head shard of each pool (and scale) per rank, on its
            # device: lists the model's serving functions take as they are
            names = ("_kp", "_vp", "_kscale", "_vscale")[:4 if self._kv_q
                                                          else 2]
            for name, dim in zip(names, pool_specs(len(names))):
                setattr(self, name, shard(getattr(self, name), dim,
                                          self._devices))
        self._alloc = BlockAllocator(self.n_blocks)
        # int8: a recycled page must drop its last tenant's running-max
        # scale before its next write
        self._alloc.track_allocations = self._kv_q
        self._cache = PrefixCache(self._alloc, self.block_size) \
            if self._prefix_on else None
        self._tables = np.zeros((B, self._max_blocks), np.int32)
        self._lens = np.zeros((B,), np.int32)
        self._tok = np.zeros((B,), np.int32)
        self._rows = [None] * B         # per-slot host state

    def _dev(self, a):
        return torch.as_tensor(a, device=self.device)

    def _weights(self):
        """(stacked, embed, final_norm, lm_head) as the serving functions
        take them. On a mesh the stacked weights are split once per
        engine into per-rank shards on the ranks' devices, and the rest
        is placed on rank 0's device (the reference's
        ``_placed_weights``)."""
        if self.mesh is None:
            return self.model.weights()
        if self._placed is None:
            st, embed, fnorm, head = self.model.weights()
            dev = self._devices[0]
            self._placed = (shard_weights(st, self._devices), embed.to(dev),
                            fnorm.to(dev), head.to(dev))
        return self._placed

    # -- pool plumbing ------------------------------------------------------
    def _kv_scales(self):
        """(kscale, vscale) [L, N, kvh] for int8 pools, None for fp: what
        the model functions take beside the pools (the reference threads
        them through its programs with ``_pool``/``_set_pool``; here
        both are updated in place)."""
        return (self._kscale, self._vscale) if self._kv_q else None

    def _drain_scale_resets(self):
        """int8 only: reset the scales of the pages handed out since the
        last drain to the floor. A recycled page keeps its codes (masked
        by the row's length until overwritten) but must not keep its
        last tenant's scale, which only grows and would coarsen every
        row quantized into it. Runs before every call that writes KV,
        and before a copy-on-write, which would otherwise have its
        copied scales reset."""
        if not self._kv_q:
            return
        dirty = self._alloc.drain_allocated()
        if dirty:
            idx = np.asarray(dirty, np.int64)
            for a in _llama._ranks(self._kscale) + _llama._ranks(
                    self._vscale):
                a[:, torch.as_tensor(idx, device=a.device)] = KV_SCALE_EPS

    def _copy_page(self, src, dst):
        """Copy-on-write: page ``src`` into the row's private page
        ``dst`` in every layer (and rank), with its scales on an int8
        pool."""
        for pool in (self._kp, self._vp) + (self._kv_scales() or ()):
            for a in _llama._ranks(pool):
                a[:, dst] = a[:, src]
        self._c_device_calls.inc()

    # -- engine state -------------------------------------------------------
    def _no_rows(self) -> bool:
        return all(r is None for r in self._rows)

    def _n_live(self) -> int:
        return sum(r is not None for r in self._rows)

    def _decode_ready(self) -> bool:
        """Some live row is past its (chunked) prefill."""
        return any(r is not None and "pf_seq" not in r for r in self._rows)

    def idle(self) -> bool:
        """No live rows and no scheduler backlog."""
        return self._no_rows() and not self.backlog

    @property
    def backlog(self) -> int:
        """Requests the scheduler holds that no slot or pages funded yet."""
        return len(self._sched)

    @property
    def prefill_backlog(self) -> int:
        """Prompt tokens not yet prefilled: the queued requests' whole
        prompts plus the unprefilled rest of rows mid chunked prefill."""
        return self._sched.pending_tokens() + sum(
            r["pf_seq"].size - r["pf_pos"] for r in self._rows
            if r is not None and "pf_seq" in r)

    def stats(self) -> dict:
        """Lifecycle counters, pool occupancy, prefix-cache hits and,
        with ``spec_decode``, the draft counts."""
        s = {"admitted": int(self._c_admitted.value),
             "retired": int(self._c_retired.value),
             "failed": int(self._c_failed.value),
             "preempted": int(self._c_preempted.value),
             "prefix_hit_tokens": int(self._c_prefix_hit.value),
             "device_steps": self.device_steps,
             "device_calls": int(self._c_device_calls.value),
             "tp_degree": self._tp,
             "seq_degree": self._seq,
             "prefills": self.prefills,
             "resets": self.resets,
             "pool": self._alloc.stats(),
             "backlog": self.backlog,
             "prefill_backlog": self.prefill_backlog,
             "prefill_chunks": int(self._c_prefill_chunks.value),
             "kv_dtype": self.kv_dtype}
        if self.mesh is not None:
            s["mesh_shape"] = dict(self.mesh.shape)
        if self._cache is not None:
            s["prefix_cache"] = self._cache.stats()
        if self.spec_decode:
            prop = int(self._c_spec_proposed.value)
            acc = int(self._c_spec_accepted.value)
            steps = int(self._h_spec_accept.count)
            s["spec"] = {
                "proposed": prop, "accepted": acc,
                "accept_rate": acc / prop if prop else 0.0,
                "verify_steps": steps,
                # emitted per verify step, the free first token included
                "tokens_per_step":
                    self._h_spec_accept.sum / steps if steps else 0.0}
        return s

    # -- lifecycle telemetry ------------------------------------------------
    def _trace_admission(self, req):
        tr = req.trace
        t_adm = tr.mark("admitted")
        tq = tr.last("queued")
        self._h_queue_wait.observe(
            t_adm - (tq if tq is not None else tr.arrival))

    def _observe_first_token(self, req):
        tf = req.trace.mark_once("first_token")
        if tf is not None:
            self._h_ttft.observe(tf - req.trace.arrival)

    def _observe_retired(self, req):
        self._c_retired.inc()
        tr = req.trace
        t_ret = tr.mark("retired")
        tf = tr.first("first_token")
        if tf is not None and req.max_new > 1:
            self._h_tpot.observe((t_ret - tf) / (req.max_new - 1))
        log_kv(_log, "retired", level=logging.DEBUG,
               req=tr.request_id,
               new_tokens=req.max_new, preemptions=tr.preemptions)

    def _fail_request(self, req, err):
        req.error = err
        req.event.set()
        self._c_failed.inc()
        req.trace.mark("failed")
        log_kv(_log, "request_failed", level=logging.WARNING,
               req=req.trace.request_id,
               error=type(err).__name__, detail=str(err))

    # -- admission ----------------------------------------------------------
    def submit(self, input_ids, max_new_tokens=32, priority=0):
        """Validated single-request entry: builds the request (raising
        ``ValueError`` on an empty prompt or a non-positive budget) and
        queues it. Returns the handle; ``wait()`` gives the prompt plus
        the generated tokens. Admission happens in :meth:`admit`."""
        req = _Request(input_ids, max_new_tokens, priority=priority)
        self._sched.add(req)
        return req

    def admit(self, pending):
        """Queue the requests of ``pending`` (a list, consumed in order)
        and admit queued requests into free slots, highest priority
        first, charging only the uncached suffix pages after a prefix
        match. When the pool runs short, unreferenced cached pages are
        evicted and strictly-lower-priority rows preempted before
        admission waits."""
        while pending:
            self._sched.add(pending.pop(0))
        with torch.no_grad():
            self._admit_scheduled()

    def _pick_victim(self, prio, exclude=None):
        """Slot of the running row to preempt for a priority-``prio``
        claimant: strictly lower priority only, lowest priority first,
        newest arrival first among equals; None when none qualifies."""
        best = None
        for slot, row in enumerate(self._rows):
            if row is None or slot == exclude:
                continue
            p = row["req"].priority
            if p >= prio:
                continue
            if best is None or (p, -row["req"]._sched_seq) < \
                    (self._rows[best]["req"].priority,
                     -self._rows[best]["req"]._sched_seq):
                best = slot
        return best

    def _release_row_pages(self, row):
        for p in row["pages"]:
            self._alloc.decref(p)

    def _cached_seq(self, row):
        """Tokens whose KV is resident for the row: the prompt plus
        every emitted token but the last (the next decode input)."""
        if len(row["toks"]) > 1:
            return np.concatenate(
                [row["prompt"], np.asarray(row["toks"][:-1], np.int32)])
        return row["prompt"]

    def _preempt_row(self, slot):
        """Evict a running row for recompute-resume: publish its resident
        prefix to the cache, release its references and re-queue it
        with its emitted tokens, so resumption is lossless. A row still
        mid chunked prefill publishes only its completed pages (the
        partial page's tail is unwritten) and re-queues with the tokens
        it had before this stint."""
        bs = self.block_size
        row = self._rows[slot]
        req = row["req"]
        if "pf_seq" in row:
            valid = int(row["pf_pos"])
            full = (valid // bs) * bs
            if self._cache is not None and full > 0:
                self._cache.insert(row["pf_seq"][:full],
                                   row["pages"][:full // bs])
            req._resume_toks = row["pf_resume"]
        else:
            valid = int(self._lens[slot])
            if self._cache is not None and valid > 0:
                self._cache.insert(self._cached_seq(row)[:valid],
                                   row["pages"][:-(-valid // bs)])
            req._resume_toks = list(row["toks"])
        self._release_row_pages(row)
        self._c_preempted.inc()
        req.trace.mark("preempted")
        self._tables[slot] = 0
        self._lens[slot] = 0
        self._tok[slot] = 0
        self._rows[slot] = None
        self._sched.add(req)
        log_kv(_log, "preempted", level=logging.DEBUG,
               req=req.trace.request_id,
               slot=slot, resident_tokens=valid,
               emitted=len(req._resume_toks or []))

    def _reclaim_allocate(self, need, prio, exclude=None):
        """allocate() with reclamation: evict unreferenced cached pages,
        then preempt strictly-lower-priority rows; None when the pool
        still cannot cover ``need``."""
        pages = self._alloc.allocate(need)
        if pages is not None:
            return pages
        if self._cache is not None:
            self._evict_cached(self._alloc.shortfall(need))
            pages = self._alloc.allocate(need)
            if pages is not None:
                return pages
        while True:
            victim = self._pick_victim(prio, exclude=exclude)
            if victim is None:
                return None
            self._preempt_row(victim)
            if self._cache is not None:
                self._evict_cached(self._alloc.shortfall(need))
            pages = self._alloc.allocate(need)
            if pages is not None:
                return pages

    def _evict_cached(self, n):
        freed = self._cache.evict(n)
        if freed:
            log_kv(_log, "cache_evicted", level=logging.DEBUG,
                   pages=freed, pool_free=self._alloc.num_free)
        return freed

    def _admit_scheduled(self):
        bs = self.block_size
        while self._sched:
            slot = next((i for i, r in enumerate(self._rows)
                         if r is None), None)
            if slot is None:
                return              # no slot: wait for a retire
            req = self._sched.peek()
            prompt = req.ids.reshape(-1).astype(np.int32)
            n = prompt.size
            if n > self.s_max - self.chunk:
                self._sched.pop()
                self._fail_request(req, ValueError(
                    f"prompt of {n} tokens exceeds engine s_max="
                    f"{self.s_max}"))
                continue
            resume = req._resume_toks
            # KV-resident before decode: prompt + emitted tokens minus
            # the last one (the next input)
            seq = prompt if not resume else np.concatenate(
                [prompt, np.asarray(resume[:-1], np.int32)])
            ns = seq.size
            total_need = -(-ns // bs)
            m = self._cache.match(seq, ns - 1) \
                if self._cache is not None else None
            f = len(m.pages) if m is not None else 0
            pages = self._reclaim_allocate(total_need - f, req.priority)
            if pages is None and m is not None and m.cached_len:
                # the match's own references pin evictable pages: retry
                # cold so the infeasibility test below is exact
                self._cache.release(m)
                m = None
                pages = self._reclaim_allocate(total_need, req.priority)
            if pages is None:
                if m is not None:
                    self._cache.release(m)
                if self._no_rows():
                    self._sched.pop()
                    self._fail_request(req, RuntimeError(
                        f"prompt needs {total_need} pages but the pool "
                        f"holds {self._alloc.capacity} "
                        f"(n_blocks={self.n_blocks}, bs={bs})"))
                    continue
                return          # wait: running rows will free pages
            self._sched.pop()
            self._trace_admission(req)
            # before the prefill: releasing the copied page zeroes the
            # match's cow_len
            hit_tokens = m.cached_len if m is not None else 0
            if self.chunked_prefill:
                try:
                    self._begin_chunked_prefill(slot, req, prompt, seq, m,
                                                pages, resume, hit_tokens)
                except Exception as e:  # noqa: BLE001 — fail THIS
                    if m is not None:   # request, not the whole engine
                        self._cache.release(m)
                    self._alloc.free(pages)
                    self._fail_request(req, e)
                continue
            try:
                first_tok = self._prefill_row(slot, seq, m, pages)
            except Exception as e:  # noqa: BLE001 — fail THIS request,
                if m is not None:   # not the whole engine
                    self._cache.release(m)
                self._alloc.free(pages)
                self._fail_request(req, e)
                continue
            all_pages = (m.pages if m is not None else []) + pages
            toks = list(resume) if resume else [first_tok]
            req._resume_toks = None
            self.prefills += 1
            self._c_prefills.inc()
            self._c_admitted.inc()
            self._c_prefix_hit.inc(hit_tokens)
            self._observe_first_token(req)
            log_kv(_log, "admitted", level=logging.DEBUG,
                   req=req.trace.request_id,
                   slot=slot, tokens=int(ns), cached_tokens=hit_tokens,
                   pages=len(all_pages), resumed=bool(resume))
            self._lens[slot] = ns
            self._tok[slot] = toks[-1]
            self._rows[slot] = {"req": req, "prompt": prompt,
                                "toks": toks, "pages": all_pages}

    def _prefill_row(self, slot, seq, m, pages):
        """Admission prefill of ``seq`` into ``pages`` (after the match's
        shared pages), seeding the slot's block table. Cold: the whole
        ``s_max`` window. Prefix hit: copy the partly shared page if
        any, then prefill the uncached tail over a bucketed window.
        Returns the argmax token at the last real position."""
        ns = seq.size
        cached = m.cached_len if m is not None else 0
        table_row = np.zeros((self._max_blocks,), np.int32)
        allp = (m.pages if m is not None else []) + pages
        table_row[:len(allp)] = allp
        self._drain_scale_resets()
        if cached == 0:
            ids = np.full((1, self.s_max), self.pad_id, np.int32)
            ids[0, self.s_max - ns:] = seq
            pad = self.s_max - ns
            logits, ks, vs = _llama.masked_prefill(
                self._cfg, *self._weights(), self._dev(ids).long(),
                self._dev(np.asarray([pad])))
            _llama.scatter_prefill_kv(self._kp, self._vp, ks, vs,
                                      self._dev(table_row), pad,
                                      kv_scales=self._kv_scales())
            self._c_device_calls.inc()
        else:
            if m.cow_src is not None:
                # private copy of the partly shared page: the tail's first
                # write lands mid-page at position ``cached``
                self._copy_page(m.cow_src, pages[0])
                self._cache.release_cow(m)
            logits, _ = self._tail_prefill(seq[cached:], cached, table_row)
        self._tables[slot] = table_row
        return int(logits.argmax(dim=-1)[0])

    def _tail_prefill(self, tail, prefix_len, table_row, all_logits=False):
        """``tail`` through the position-offset prefill over the
        ``prefix_len`` tokens resident through ``table_row``, right-
        aligned in a bucketed window; its K/V land in the pools. Returns
        (logits, left pads): the last position's logits [1, V], or every
        window position's [1, sc, V] with ``all_logits``. Serves
        prefix-hit admission, prefill chunks and verify steps."""
        sc = self._bucket_window(tail.size)
        pad = sc - tail.size
        ids = np.full((1, sc), self.pad_id, np.int32)
        ids[0, pad:] = tail
        logits = _llama.prefix_prefill(
            self._cfg, *self._weights(), self._dev(ids).long(),
            self._dev(np.asarray([pad])), self._dev(np.asarray([prefix_len])),
            self._kp, self._vp, self._dev(table_row),
            kv_scales=self._kv_scales(), all_logits=all_logits)
        self._c_device_calls.inc()
        return logits, pad

    # -- chunked prefill ----------------------------------------------------
    def _begin_chunked_prefill(self, slot, req, prompt, seq, m, pages,
                               resume, hit_tokens):
        """Chunked admission: take the slot and the pages (copying the
        partly shared prefix page) now, and leave the prompt forward to
        the steps' budgets. The row keeps its block table PRIVATE in
        ``pf_table`` until the last chunk lands: the slot's table stays
        all-NULL, so the decode step's writes for this lane go to the
        NULL page instead of over the chunks' K/V."""
        cached = m.cached_len if m is not None else 0
        self._drain_scale_resets()      # before the copy: keep its scales
        if m is not None and m.cow_src is not None:
            self._copy_page(m.cow_src, pages[0])
            self._cache.release_cow(m)
        all_pages = (m.pages if m is not None else []) + pages
        table_row = np.zeros((self._max_blocks,), np.int32)
        table_row[:len(all_pages)] = all_pages
        req._resume_toks = None
        self._c_admitted.inc()
        self._c_prefix_hit.inc(hit_tokens)
        log_kv(_log, "admitted", level=logging.DEBUG,
               req=req.trace.request_id, slot=slot, tokens=int(seq.size),
               cached_tokens=hit_tokens, pages=len(all_pages),
               resumed=bool(resume), chunked=True)
        self._rows[slot] = {"req": req, "prompt": prompt, "toks": [],
                            "pages": all_pages,
                            "pf_seq": seq,          # the resident goal
                            "pf_pos": cached,       # tokens resident
                            "pf_table": table_row,  # private until done
                            "pf_resume": list(resume) if resume
                            else None}

    def _run_prefill_chunks(self, budget):
        """Spend what is left of the step's budget on prefill chunks:
        the scheduler funds whole chunks in priority/arrival order, and
        each funded chunk runs one tail prefill. The chunk that
        completes a prompt emits its first token and puts the row into
        the decode batch."""
        slots, cands = {}, []
        for slot, row in enumerate(self._rows):
            if row is None or "pf_seq" not in row:
                continue
            take = min(self.prefill_chunk,
                       row["pf_seq"].size - row["pf_pos"])
            cands.append((row["req"], take))
            slots[id(row["req"])] = slot
        for req, take in self._sched.plan_prefill(budget, cands):
            slot = slots[id(req)]
            try:
                self._prefill_chunk_row(slot, self._rows[slot], take)
            except Exception as e:  # noqa: BLE001 — fail THIS request,
                self._fail_row_paged(slot, e)  # not the whole engine

    def _prefill_chunk_row(self, slot, row, take):
        """One funded chunk: ``take`` prompt tokens after the
        ``pf_pos`` already resident, scattered through the private
        table."""
        req = row["req"]
        seq, pos = row["pf_seq"], int(row["pf_pos"])
        tail = seq[pos:pos + take]
        self._drain_scale_resets()
        logits, _ = self._tail_prefill(tail, pos, row["pf_table"])
        row["pf_pos"] = pos + tail.size
        self._c_prefill_chunks.inc()
        req.trace.mark("prefill_chunk")
        if row["pf_pos"] >= seq.size:
            # the last chunk's logits are the prompt's: first token,
            # table installed, decoding from this step on
            resume = row.pop("pf_resume")
            toks = list(resume) if resume else [int(logits.argmax(-1)[0])]
            self._tables[slot] = row.pop("pf_table")
            self._lens[slot] = seq.size
            self._tok[slot] = toks[-1]
            row["toks"] = toks
            del row["pf_seq"], row["pf_pos"]
            self.prefills += 1
            self._c_prefills.inc()
            self._observe_first_token(req)

    def _bucket_window(self, n: int) -> int:
        """Window of a position-offset prefill (prefix hit, prefill
        chunk, verify): a power of two from 16, capped at s_max (the
        reference compiles one program per bucket; the port keeps the
        windows so results match)."""
        b = 16
        while b < n:
            b *= 2
        return min(b, self.s_max)

    # -- decode -------------------------------------------------------------
    def decode_once(self):
        """Run ONE engine step: with ``spec_decode`` a verify step per
        decode-ready row, else a decode chunk of ``chunk`` greedy steps
        (under chunked prefill, after the step's prefill chunks). On a
        mesh, a step that holds a verify window or a prefill chunk is
        one mixed step instead. Collect the tokens and retire finished
        rows (their ``wait()`` returns at once). Returns the number of
        rows still alive."""
        if self.idle():
            return 0
        with torch.no_grad():
            if self.mesh is not None and (
                    self.spec_decode
                    or (self.chunked_prefill
                        and any(r is not None and "pf_seq" in r
                                for r in self._rows))):
                # every window of the step in ONE launch; plain decode
                # with no row mid-prefill keeps the decode chunk
                # (chunk tokens per call beat one)
                return self._decode_once_mixed()
            if self.spec_decode:
                return self._decode_once_spec()
            return self._decode_once_paged()

    def _retire_paged(self, slot, publish=True):
        """Release the row's pages and clear its lane. A clean retire
        first publishes the row's resident prefix to the prefix cache;
        a failed row releases without publishing."""
        row = self._rows[slot]
        if publish and self._cache is not None:
            req = row["req"]
            valid = row["prompt"].size + req.max_new - 1
            seq = np.concatenate(
                [row["prompt"],
                 np.asarray(row["toks"][:req.max_new - 1], np.int32)])
            self._cache.insert(seq, row["pages"][:-(-valid //
                                                    self.block_size)])
        if publish:
            self._observe_retired(row["req"])
        self._release_row_pages(row)
        self._tables[slot] = 0          # all-NULL: inactive lane
        self._lens[slot] = 0
        self._tok[slot] = 0
        self._rows[slot] = None

    def _fail_row_paged(self, slot, err):
        self._fail_request(self._rows[slot]["req"], err)
        self._retire_paged(slot, publish=False)

    def _finish_if_done(self, slot, row):
        """Retire the row once it holds ``max_new`` tokens; returns
        whether it did."""
        req = row["req"]
        if len(row["toks"]) < req.max_new:
            return False
        req.result = np.concatenate(
            [row["prompt"], np.asarray(row["toks"][:req.max_new], np.int32)])
        self._retire_paged(slot)        # pages free to re-admit
        req.event.set()
        return True

    def _step_budget(self):
        """This step's token budget (fleet migration, which charges the
        reference's budget with transplanted tokens, is not ported)."""
        return StepBudget(self.step_budget)

    def _grow_decode_row(self, slot, row, n_new) -> bool:
        """Give ONE decode-ready row the pages that ``n_new`` more KV
        writes need. Returns True when the row survived with its table
        covering them; else the row was failed or preempted itself
        losslessly, and nothing may run for it. Growth may preempt
        other rows, strictly lower priority first; under chunked
        prefill a row that is decoding also outranks equal-or-lower-
        priority rows still mid-prefill, which lose the least work and
        resume losslessly (without that, a tiny pool livelocks)."""
        bs = self.block_size
        req = row["req"]
        lens0 = int(self._lens[slot])
        target = lens0 + n_new
        if target > self.s_max:
            self._fail_row_paged(slot, RuntimeError(
                f"row exceeds engine s_max={self.s_max} at length "
                f"{lens0}"))
            return False
        extra = -(-target // bs) - len(row["pages"])
        if extra <= 0:
            return True
        pages = self._reclaim_allocate(extra, req.priority, exclude=slot)
        if pages is None and self.chunked_prefill:
            pf = [i for i, r in enumerate(self._rows)
                  if r is not None and i != slot and "pf_seq" in r
                  and r["req"].priority <= req.priority]
            pf.sort(key=lambda i: -self._rows[i]["req"]._sched_seq)
            while pages is None and pf:     # newest arrival first
                self._preempt_row(pf.pop(0))
                if self._cache is not None:
                    self._evict_cached(self._alloc.shortfall(extra))
                pages = self._alloc.allocate(extra)
        if pages is None:
            others = any(r is not None and i != slot
                         for i, r in enumerate(self._rows))
            if others and self._cache is not None:
                # lossless self-preemption: park the prefix in the cache
                # and resume when the survivors retire
                self._preempt_row(slot)
                return False
            self._fail_row_paged(slot, RuntimeError(
                f"paged KV pool exhausted: needed {extra} more pages, "
                f"{self._alloc.num_free} free (n_blocks={self.n_blocks}, "
                f"bs={bs})"))
            return False
        start = len(row["pages"])
        row["pages"] = row["pages"] + pages
        self._tables[slot, start:start + extra] = pages
        return True

    def _grow_rows(self):
        """Grow every decode-ready row for this chunk's writes, in
        ascending order of need: a starved row's freed pages rescue the
        rows after it. Rows mid-prefill never grow: admission gave them
        the pages of their whole prompt."""
        bs = self.block_size
        grow = []
        for slot, row in enumerate(self._rows):
            if row is None or "pf_seq" in row:
                continue
            use = min(self.chunk, row["req"].max_new - len(row["toks"]))
            need = -(-(int(self._lens[slot]) + use) // bs) - len(row["pages"])
            grow.append((need, slot, row, use))
        for _, slot, row, use in sorted(grow, key=lambda t: t[0]):
            if self._rows[slot] is row:     # else preempted by a claim
                self._grow_decode_row(slot, row, use)

    def _decode_chunk(self):
        """``chunk`` greedy steps for every lane: tokens [chunk, B]."""
        st, embed, fnorm, lm = self._weights()
        tables = self._dev(self._tables)
        lens = self._dev(self._lens)
        tok = self._dev(self._tok).long()
        scales = self._kv_scales() or (None, None)
        out = []
        for i in range(self.chunk):
            logits = _llama._paged_decode_step(
                self._cfg, st, embed, fnorm, lm, tok, self._kp, self._vp,
                tables, lens + i, *scales, attn=paged_decode_attention)
            tok = logits.argmax(dim=-1)
            out.append(tok)
        return torch.stack(out).cpu().numpy()   # fetch = sync

    def _decode_lane_tokens(self, row):
        return min(self.chunk, row["req"].max_new - len(row["toks"]))

    def _decode_once_paged(self):
        if self.chunked_prefill:
            # decode lanes claim their tokens first (decode is never
            # throttled), prefill chunks spend the rest; a row whose last
            # chunk lands joins this step's decode
            budget = self._step_budget()
            pre = set()
            for slot, row in enumerate(self._rows):
                if row is not None and "pf_seq" not in row:
                    pre.add(slot)
                    budget.take(self._decode_lane_tokens(row), force=True)
            self._run_prefill_chunks(budget)
            for slot, row in enumerate(self._rows):
                if row is not None and "pf_seq" not in row \
                        and slot not in pre:
                    budget.take(self._decode_lane_tokens(row), force=True)
            self._h_budget.observe(budget.used)
            if not self._decode_ready():
                # every live row is mid-prefill: no decode this step
                return self._n_live()
        self._grow_rows()
        if self._no_rows():
            return 0
        if not self._decode_ready():
            return self._n_live()
        self._drain_scale_resets()
        t0 = _now()
        toks = self._decode_chunk()
        wall = _now() - t0
        self.device_steps += self.chunk
        self._c_steps.inc(self.chunk)
        self._c_device_calls.inc()
        self._h_chunk.observe(wall)
        n_busy = self._n_live()
        self._g_occupancy.set(n_busy)
        log_event("engine_chunk", steps=self.chunk, rows=n_busy,
                  fill=int(self._lens.max()), wall_s=round(wall, 4),
                  tokens_per_s=round(self.chunk * n_busy
                                     / max(wall, 1e-9), 1),
                  blocks_used=self._alloc.num_used,
                  blocks_free=self._alloc.num_free)
        alive = 0
        for slot, row in enumerate(self._rows):
            if row is None:
                continue
            if "pf_seq" in row:
                alive += 1      # mid-prefill: its lane wrote the NULL page
                continue
            useful = self._decode_lane_tokens(row)
            row["toks"].extend(int(t) for t in toks[:, slot])
            self._tok[slot] = int(toks[-1, slot])
            row["req"].trace.mark("decode_chunk", n_tokens=useful)
            if not self._finish_if_done(slot, row):
                self._lens[slot] += self.chunk
                alive += 1
        return alive

    # -- self-speculative decoding ------------------------------------------
    def _draft_for(self, slot, row):
        """Draft tokens for one decode-ready row from its own history,
        clamped so that its verify step emits at most ``max_new`` tokens
        in all and writes no KV past ``s_max``."""
        req = row["req"]
        limit = min(req.max_new - len(row["toks"]) - 1,
                    self.s_max - int(self._lens[slot]) - 1)
        if limit <= 0:
            return np.zeros((0,), np.int32)
        ctx = np.concatenate([row["prompt"],
                              np.asarray(row["toks"], np.int32)])
        return self._drafter.propose(ctx, limit=limit)

    def _decode_once_spec(self):
        """One speculative step: every decode-ready row drafts from its
        own history and verifies the drafts in one position-offset
        prefill (:meth:`_verify_row`), accepting 1..k+1 tokens, each of
        them the greedy argmax. Rejected drafts roll back by the length
        alone: ``lens`` advances past the accepted positions only, and
        their stale KV is masked until overwritten. Under chunked
        prefill the decode lanes charge their k+1 verify tokens to the
        budget first and prefill chunks spend the rest; rows whose last
        chunk lands verify in this step too."""
        drafts = {}
        if self.chunked_prefill:
            budget = self._step_budget()
            for slot, row in enumerate(self._rows):
                if row is not None and "pf_seq" not in row:
                    drafts[slot] = d = self._draft_for(slot, row)
                    budget.take(d.size + 1, force=True)
            self._run_prefill_chunks(budget)
            for slot, row in enumerate(self._rows):
                if row is not None and "pf_seq" not in row \
                        and slot not in drafts:
                    drafts[slot] = d = self._draft_for(slot, row)
                    budget.take(d.size + 1, force=True)
            self._h_budget.observe(budget.used)
        self._g_occupancy.set(self._n_live())
        alive = 0
        for slot in range(self.capacity):
            row = self._rows[slot]
            if row is None:
                continue
            if "pf_seq" in row:
                alive += 1              # mid-prefill: alive, not decoding
                continue
            d = drafts.get(slot)
            if d is None:
                # drafted here: no chunked prefill, or the row came back
                # after a preemption since drafting
                d = self._draft_for(slot, row)
            try:
                self._verify_row(slot, row, d)
            except Exception as e:  # noqa: BLE001 — fail THIS request,
                if self._rows[slot] is row:  # not the whole engine
                    self._fail_row_paged(slot, e)
                continue
            if self._rows[slot] is not None:
                alive += 1
        return alive

    def _verify_row(self, slot, row, draft):
        """Grow, verify and accept for ONE row (one device step). The
        window is the pending token and the k drafts at ``prefix_len =
        lens``; position i's argmax is the true next token as long as
        every earlier draft matched, so the accepted run is exactly
        what k+1 plain greedy steps would emit. A row preempted by
        another row's growth between drafting and verifying is skipped
        by the caller and resumes losslessly."""
        req = row["req"]
        k = int(draft.size)
        lens0 = int(self._lens[slot])
        if not self._grow_decode_row(slot, row, k + 1):
            return
        self._drain_scale_resets()
        tail = np.concatenate([self._tok[slot:slot + 1],
                               draft]).astype(np.int32)
        t0 = _now()
        logits, pad = self._tail_prefill(tail, lens0, self._tables[slot],
                                         all_logits=True)
        preds = logits[0, pad:].argmax(-1).cpu().numpy()   # [k+1]
        self._h_chunk.observe(_now() - t0)
        self.device_steps += 1
        self._c_steps.inc(1)
        out = [int(preds[0])]
        for i in range(k):
            if int(draft[i]) != out[i]:
                break
            out.append(int(preds[i + 1]))
        self._c_spec_proposed.inc(k)
        self._c_spec_accepted.inc(len(out) - 1)
        self._h_spec_accept.observe(len(out))
        req.trace.mark("spec_verify")
        row["toks"].extend(out)
        self._tok[slot] = out[-1]
        req.trace.mark("decode_chunk", n_tokens=len(out))
        if not self._finish_if_done(slot, row):
            self._lens[slot] = lens0 + len(out)

    # -- the single-launch mixed step (mesh engines) ------------------------
    def _decode_once_mixed(self):
        """ONE device call per engine step: every decode-ready row's
        window (its pending token and k drafts; k = 0 without
        ``spec_decode``) and every funded prefill chunk go through a
        single :func:`mixed_paged_step` with per-row ``q_lens``. Each
        emitted token is the step's argmax at its position and
        acceptance walks the same greedy chain as :meth:`_verify_row`,
        so per-request tokens equal the per-row paths'. The schedule
        differs (a row whose last chunk lands decodes from the NEXT
        step; a plain decode lane advances one token per step), so the
        counters do."""
        def draft(slot, row):
            return self._draft_for(slot, row) if self.spec_decode \
                else np.zeros((0,), np.int32)

        # plan: decode lanes force-charge their verify tokens, prefill
        # chunks are funded from the rest, as on the per-row paths
        drafts, chunk_plan = {}, []
        if self.chunked_prefill:
            budget = self._step_budget()
            for slot, row in enumerate(self._rows):
                if row is not None and "pf_seq" not in row:
                    drafts[slot] = d = draft(slot, row)
                    budget.take(d.size + 1, force=True)
            slots, cands = {}, []
            for slot, row in enumerate(self._rows):
                if row is None or "pf_seq" not in row:
                    continue
                take = min(self.prefill_chunk,
                           row["pf_seq"].size - row["pf_pos"])
                cands.append((row["req"], take))
                slots[id(row["req"])] = slot
            for req, take in self._sched.plan_prefill(budget, cands):
                chunk_plan.append((slots[id(req)], take))
            self._h_budget.observe(budget.used)
        for slot, row in enumerate(self._rows):
            if row is not None and "pf_seq" not in row \
                    and slot not in drafts:
                drafts[slot] = draft(slot, row)
        # grow decode lanes for this step's writes (growth may preempt
        # other rows: the windows below take only the survivors)
        for slot in sorted(drafts):
            row = self._rows[slot]
            if row is not None and "pf_seq" not in row:
                self._grow_decode_row(slot, row, int(drafts[slot].size) + 1)
        # LEFT-aligned windows; kv_lens include the window (scatter-then-
        # attend); chunk lanes write through their private tables; idle
        # lanes have q_len 0
        windows = []
        for slot, take in chunk_plan:
            row = self._rows[slot]
            if row is None or "pf_seq" not in row:
                continue            # preempted by a decode lane's growth
            pos0 = int(row["pf_pos"])
            tail = np.asarray(row["pf_seq"][pos0:pos0 + take], np.int32)
            windows.append((slot, row, "chunk", tail, pos0 + tail.size,
                            row["pf_table"]))
        for slot in sorted(drafts):
            row = self._rows[slot]
            if row is None or "pf_seq" in row:
                continue            # preempted or failed while growing
            tail = np.concatenate([self._tok[slot:slot + 1],
                                   drafts[slot]]).astype(np.int32)
            windows.append((slot, row, "decode", tail,
                            int(self._lens[slot]) + tail.size,
                            self._tables[slot]))
        n_busy = self._n_live()
        self._g_occupancy.set(n_busy)
        if not windows:
            return n_busy
        B = self.capacity
        T = self._bucket_window(max(w[3].size for w in windows))
        ids = np.full((B, T), self.pad_id, np.int32)
        q_lens = np.zeros((B,), np.int32)
        kv_lens = np.zeros((B,), np.int32)
        tabs = np.zeros((B, self._max_blocks), np.int32)
        for slot, _, _, tail, kvl, table in windows:
            ids[slot, :tail.size] = tail
            q_lens[slot] = tail.size
            kv_lens[slot] = kvl
            tabs[slot] = table
        self._drain_scale_resets()
        t0 = _now()
        with torch.profiler.record_function("engine.mixed_step"):
            preds = _llama.mixed_paged_step(
                self._cfg, *self._weights(), self._dev(ids).long(),
                self._dev(q_lens), self._dev(kv_lens), self._dev(tabs),
                self._kp, self._vp, *(self._kv_scales() or (None, None)),
                attn=mixed_paged_attention).cpu().numpy()   # fetch = sync
        wall = _now() - t0
        self.device_steps += 1
        self._c_steps.inc(1)
        self._c_device_calls.inc()
        self._h_chunk.observe(wall)
        log_event("engine_mixed_step", rows=len(windows), window=T,
                  wall_s=round(wall, 4), blocks_used=self._alloc.num_used,
                  blocks_free=self._alloc.num_free)
        for slot, row, kind, tail, kvl, _ in windows:
            if self._rows[slot] is not row:
                continue
            req = row["req"]
            if kind == "chunk":
                row["pf_pos"] = int(row["pf_pos"]) + tail.size
                self._c_prefill_chunks.inc()
                req.trace.mark("prefill_chunk")
                if row["pf_pos"] >= row["pf_seq"].size:
                    # the last chunk's last real argmax is the first token
                    resume = row.pop("pf_resume")
                    toks = list(resume) if resume \
                        else [int(preds[slot, tail.size - 1])]
                    self._tables[slot] = row.pop("pf_table")
                    self._lens[slot] = row["pf_seq"].size
                    self._tok[slot] = toks[-1]
                    row["toks"] = toks
                    del row["pf_seq"], row["pf_pos"]
                    self.prefills += 1
                    self._c_prefills.inc()
                    self._observe_first_token(req)
                continue
            # decode or verify lane: the greedy accept chain
            k = tail.size - 1
            out = [int(preds[slot, 0])]
            for i in range(k):
                if int(tail[i + 1]) != out[i]:
                    break
                out.append(int(preds[slot, i + 1]))
            if self.spec_decode:
                self._c_spec_proposed.inc(k)
                self._c_spec_accepted.inc(len(out) - 1)
                self._h_spec_accept.observe(len(out))
                req.trace.mark("spec_verify")
            row["toks"].extend(out)
            self._tok[slot] = out[-1]
            req.trace.mark("decode_chunk", n_tokens=len(out))
            if not self._finish_if_done(slot, row):
                self._lens[slot] = kvl - tail.size + len(out)
        return self._n_live()


class _Request:
    """One generation request: prompt ids, token budget, priority, its
    lifecycle trace and the event its caller waits on."""

    def __init__(self, ids, max_new, priority=0):
        self.ids = np.asarray(ids)
        if self.ids.size == 0:
            raise ValueError("input_ids is empty — nothing to prefill")
        if max_new is None or int(max_new) <= 0:
            raise ValueError(
                f"max_new_tokens must be positive, got {max_new!r}")
        self.max_new = int(max_new)
        self.priority = int(priority)   # higher = sooner; may preempt
        self.trace = RequestTrace()
        self.event = threading.Event()
        self.result = None
        self.error = None
        self._sched_seq = None          # FCFS stamp (RequestScheduler)
        self._resume_toks = None        # tokens emitted before preemption

    def wait(self, timeout=None):
        if not self.event.wait(timeout):
            raise TimeoutError("generation request timed out")
        if self.error is not None:
            raise self.error
        return self.result
