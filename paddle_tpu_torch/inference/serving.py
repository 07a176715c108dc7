"""Continuous-batching decode engine over a paged KV cache.

Counterpart of the paged, single-device, fp-KV path of
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

What differs from the reference: its per-bucket compiled programs are
plain calls here, and where it donates the pools to those programs the
port updates them in place. Every attention read of a decode step goes
through ``kernels.paged_attention.paged_decode_attention``.
"""

from __future__ import annotations

import logging
import threading

import numpy as np
import torch

from ..kernels.paged_attention import paged_decode_attention
from ..models import llama as _llama
from ..observability import MetricsRegistry, RequestTrace, now as _now
from ..utils.log import get_logger, log_event, log_kv
from .paged_cache import BlockAllocator
from .prefix_cache import PrefixCache
from .scheduler import RequestScheduler

__all__ = ["DecodeEngine"]

_log = get_logger("paddle_tpu_torch.inference.engine")


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md "
        f"Queue 1, item {item})")


class DecodeEngine:
    """Paged continuous batching for a :class:`LlamaForCausalLM`.

    Drive it with :meth:`submit` (or :meth:`admit` with a list of
    requests) and :meth:`decode_once`; each ``decode_once`` runs
    ``chunk`` greedy decode steps for every live row, retires finished
    rows and returns the number still alive. The engine runs on the
    model's device; ``device_steps`` counts executed decode steps."""

    def __init__(self, model, capacity=4, s_max=256, chunk=8, pad_id=0,
                 paged=True, block_size=16, n_blocks=None,
                 prefix_cache=True, chunked_prefill=False,
                 spec_decode=False, kv_dtype="fp", mesh=None):
        if not paged:
            raise _not_ported("the contiguous KV cache (paged=False)", 2)
        if chunked_prefill:
            raise _not_ported("chunked prefill", 2)
        if spec_decode:
            raise _not_ported("speculative decoding", 2)
        if kv_dtype != "fp":
            if kv_dtype != "int8":
                raise ValueError(f"kv_dtype={kv_dtype!r} (want 'fp' or "
                                 f"'int8')")
            raise _not_ported("int8 paged KV", 2)
        if mesh is not None:
            raise _not_ported("the sharded engine (mesh=)", 4)
        self.model = model
        self.capacity = int(capacity)
        self.s_max = int(s_max)
        self.chunk = int(chunk)
        self.pad_id = int(pad_id)
        self.block_size = int(block_size)
        self._prefix_on = bool(prefix_cache)
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
            "device calls (prefill, decode chunk, copy-on-write)")
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

    def _reset(self):
        self.resets += 1
        B = self.capacity
        shape = (self._L, self.n_blocks, self.block_size, self._kvh,
                 self._hd)
        self._kp = torch.zeros(shape, dtype=self._cache_dtype,
                               device=self.device)
        self._vp = torch.zeros_like(self._kp)
        self._alloc = BlockAllocator(self.n_blocks)
        self._cache = PrefixCache(self._alloc, self.block_size) \
            if self._prefix_on else None
        self._tables = np.zeros((B, self._max_blocks), np.int32)
        self._lens = np.zeros((B,), np.int32)
        self._tok = np.zeros((B,), np.int32)
        self._rows = [None] * B         # per-slot host state

    def _dev(self, a):
        return torch.as_tensor(a, device=self.device)

    # -- engine state -------------------------------------------------------
    def _no_rows(self) -> bool:
        return all(r is None for r in self._rows)

    def idle(self) -> bool:
        """No live rows and no scheduler backlog."""
        return self._no_rows() and not self.backlog

    @property
    def backlog(self) -> int:
        """Requests the scheduler holds that no slot or pages funded yet."""
        return len(self._sched)

    @property
    def prefill_backlog(self) -> int:
        """Queued prompt tokens not yet prefilled."""
        return self._sched.pending_tokens()

    def stats(self) -> dict:
        """Lifecycle counters, pool occupancy and prefix-cache hits."""
        s = {"admitted": int(self._c_admitted.value),
             "retired": int(self._c_retired.value),
             "failed": int(self._c_failed.value),
             "preempted": int(self._c_preempted.value),
             "prefix_hit_tokens": int(self._c_prefix_hit.value),
             "device_steps": self.device_steps,
             "device_calls": int(self._c_device_calls.value),
             "prefills": self.prefills,
             "resets": self.resets,
             "pool": self._alloc.stats(),
             "backlog": self.backlog,
             "prefill_backlog": self.prefill_backlog}
        if self._cache is not None:
            s["prefix_cache"] = self._cache.stats()
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
        with its emitted tokens, so resumption is lossless."""
        bs = self.block_size
        row = self._rows[slot]
        req = row["req"]
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
               emitted=len(req._resume_toks))

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
            hit_tokens = m.cached_len if m is not None else 0
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
        st, embed, fnorm, lm = self.model.weights()
        cfg = self._cfg
        if cached == 0:
            ids = np.full((1, self.s_max), self.pad_id, np.int32)
            ids[0, self.s_max - ns:] = seq
            pad = self.s_max - ns
            logits, ks, vs = _llama.masked_prefill(
                cfg, st, embed, fnorm, lm, self._dev(ids).long(),
                self._dev(np.asarray([pad])))
            _llama.scatter_prefill_kv(self._kp, self._vp, ks, vs,
                                      self._dev(table_row), pad)
            self._c_device_calls.inc()
        else:
            if m.cow_src is not None:
                # private copy of the partly shared page: the tail's first
                # write lands mid-page at position ``cached``
                self._kp[:, pages[0]] = self._kp[:, m.cow_src]
                self._vp[:, pages[0]] = self._vp[:, m.cow_src]
                self._cache.release_cow(m)
                self._c_device_calls.inc()
            tail = seq[cached:]
            sc = self._bucket_window(tail.size)
            ids = np.full((1, sc), self.pad_id, np.int32)
            ids[0, sc - tail.size:] = tail
            logits = _llama.prefix_prefill(
                cfg, st, embed, fnorm, lm, self._dev(ids).long(),
                self._dev(np.asarray([sc - tail.size])),
                self._dev(np.asarray([cached])), self._kp, self._vp,
                self._dev(table_row))
            self._c_device_calls.inc()
        self._tables[slot] = table_row
        return int(logits.argmax(dim=-1)[0])

    def _bucket_window(self, n: int) -> int:
        """Tail window of a prefix-hit prefill: a power of two from 16,
        capped at s_max (the reference compiles one program per
        bucket; the port keeps the windows so results match)."""
        b = 16
        while b < n:
            b *= 2
        return min(b, self.s_max)

    # -- decode -------------------------------------------------------------
    def decode_once(self):
        """Run ONE decode chunk, collect its tokens and retire finished
        rows (their ``wait()`` returns at once). Returns the number of
        rows still alive."""
        if self.idle():
            return 0
        with torch.no_grad():
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

    def _grow_rows(self):
        """Give each live row the pages this chunk's writes need, in
        ascending order of need: a starved row's freed pages rescue the
        rows after it."""
        bs = self.block_size
        grow = []
        for slot, row in enumerate(self._rows):
            if row is None:
                continue
            use = min(self.chunk, row["req"].max_new - len(row["toks"]))
            target = int(self._lens[slot]) + use
            grow.append((slot, row, target,
                         -(-target // bs) - len(row["pages"])))
        for slot, row, target, extra in sorted(grow, key=lambda t: t[3]):
            if self._rows[slot] is not row:
                continue                # preempted by an earlier claim
            if target > self.s_max:
                self._fail_row_paged(slot, RuntimeError(
                    f"row exceeds engine s_max={self.s_max} at length "
                    f"{int(self._lens[slot])}"))
                continue
            if extra <= 0:
                continue
            pages = self._reclaim_allocate(extra, row["req"].priority,
                                           exclude=slot)
            if pages is None:
                others = any(r is not None and i != slot
                             for i, r in enumerate(self._rows))
                if others and self._cache is not None:
                    # lossless self-preemption: park the prefix in the
                    # cache and resume when the survivors retire
                    self._preempt_row(slot)
                    continue
                self._fail_row_paged(slot, RuntimeError(
                    f"paged KV pool exhausted: needed {extra} more "
                    f"pages, {self._alloc.num_free} free "
                    f"(n_blocks={self.n_blocks}, bs={bs})"))
                continue
            start = len(row["pages"])
            row["pages"] = row["pages"] + pages
            self._tables[slot, start:start + extra] = pages

    def _decode_chunk(self):
        """``chunk`` greedy steps for every lane: tokens [chunk, B]."""
        st, embed, fnorm, lm = self.model.weights()
        tables = self._dev(self._tables)
        lens = self._dev(self._lens)
        tok = self._dev(self._tok).long()
        out = []
        for i in range(self.chunk):
            logits = _llama._paged_decode_step(
                self._cfg, st, embed, fnorm, lm, tok, self._kp, self._vp,
                tables, lens + i, attn=paged_decode_attention)
            tok = logits.argmax(dim=-1)
            out.append(tok)
        return torch.stack(out).cpu().numpy()   # fetch = sync

    def _decode_once_paged(self):
        self._grow_rows()
        if self._no_rows():
            return 0
        t0 = _now()
        toks = self._decode_chunk()
        wall = _now() - t0
        self.device_steps += self.chunk
        self._c_steps.inc(self.chunk)
        self._c_device_calls.inc()
        self._h_chunk.observe(wall)
        n_busy = sum(r is not None for r in self._rows)
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
            emitted_before = len(row["toks"])
            row["toks"].extend(int(t) for t in toks[:, slot])
            self._tok[slot] = int(toks[-1, slot])
            req = row["req"]
            useful = min(self.chunk, req.max_new - emitted_before)
            req.trace.mark("decode_chunk", n_tokens=useful)
            if len(row["toks"]) >= req.max_new:
                req.result = np.concatenate(
                    [row["prompt"],
                     np.asarray(row["toks"][:req.max_new], np.int32)])
                self._retire_paged(slot)  # pages free to re-admit
                req.event.set()
            else:
                self._lens[slot] += self.chunk
                alive += 1
        return alive


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
