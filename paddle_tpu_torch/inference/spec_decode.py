"""Self-speculative drafting for the paged DecodeEngine: prompt-lookup
decoding. Draft tokens come from the request's OWN prompt and output
history, with no second model.

Given the sequence the engine is about to extend (prompt plus every
emitted token, the pending next input last), the drafter finds the most
recent earlier occurrence of the sequence's n-gram suffix and proposes
the tokens that followed it. The engine verifies all of them in one
position-offset prefill and accepts the longest prefix that matches
greedy decoding, so the drafter changes how many device steps the
outputs cost and never the outputs.

``propose`` is a pure function of its arguments (longest n-gram first,
most recent match wins, no randomness), so a fixed workload replays the
same steps. Counterpart of ``paddle_tpu.inference.spec_decode``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["NgramDrafter"]


class NgramDrafter:
    """Prompt-lookup n-gram proposer over a request's own history.

    Suffixes of ``max_ngram`` down to ``min_ngram`` tokens are tried in
    turn, longest first; within one length the most recent earlier
    occurrence wins. No match at any length proposes nothing, and the
    verify step then decodes one token."""

    def __init__(self, max_draft: int = 4, max_ngram: int = 3,
                 min_ngram: int = 1):
        if max_draft < 0:
            raise ValueError(f"max_draft={max_draft}")
        if not (1 <= min_ngram <= max_ngram):
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min_ngram={min_ngram} max_ngram={max_ngram}")
        self.max_draft = int(max_draft)
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, context, limit: int | None = None) -> np.ndarray:
        """Draft up to ``min(limit, max_draft)`` tokens continuing
        ``context`` (1-D ints: prompt + emitted tokens, the pending
        next input last). The engine passes a ``limit`` that keeps the
        verify step inside the request's token budget and ``s_max``.
        Returns an int32 array, possibly empty."""
        ctx = np.asarray(context).reshape(-1).astype(np.int64)
        cap = self.max_draft if limit is None \
            else min(self.max_draft, int(limit))
        n_ctx = ctx.size
        if cap <= 0 or n_ctx < self.min_ngram + 1:
            return np.zeros((0,), np.int32)
        for n in range(min(self.max_ngram, n_ctx - 1),
                       self.min_ngram - 1, -1):
            suffix = ctx[n_ctx - n:]
            # starts i with i + n < n_ctx: the match needs at least one
            # following token to copy
            windows = np.lib.stride_tricks.sliding_window_view(
                ctx[:-1], n)                       # [n_ctx - n, n]
            hits = np.flatnonzero((windows == suffix).all(axis=1))
            if hits.size == 0:
                continue
            # the most recent match that can supply a full-length draft;
            # when every match sits too close to the end (periodic
            # tails), the earliest one gives the longest continuation
            full = hits[hits + n + cap <= n_ctx]
            i = int(full[-1]) if full.size else int(hits[0])
            out = ctx[i + n:i + n + cap]
            if out.size:
                return out.astype(np.int32)
        return np.zeros((0,), np.int32)

    def __repr__(self):
        return (f"NgramDrafter(max_draft={self.max_draft}, "
                f"max_ngram={self.max_ngram}, "
                f"min_ngram={self.min_ngram})")
