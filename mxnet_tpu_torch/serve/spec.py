"""Speculative-decoding drafters (counterpart of
``mxnet_tpu/serve/spec.py``): propose k cheap tokens per decode step for
the fused step to verify in ONE launch.

The contract: ``propose(tokens, k)`` returns up to ``k`` candidate next
tokens given the request's current sequence (prompt + generated).  The
scheduler feeds ``[last_token, d1 .. dk]`` as one multi-token row — the
ragged paged-attention step already takes multi-query-token rows (the
prefill-chunk shape) — and reads the greedy argmax at every fed position.
Position j's argmax is the greedy next token given the accepted prefix
(causal attention makes it independent of the fed tokens after j), so the
emitted tokens are those of one-token-at-a-time greedy decode: drafts only
decide how MANY correct tokens one launch yields, never WHICH tokens.  A
wrong draft costs a rejected KV write (rolled back through the page free
list), not a wrong output.

:class:`NGramDrafter` is suffix-match ("prompt lookup") drafting over the
request's own context: find the longest recent n-gram suffix that occurred
earlier in the sequence and propose the tokens that followed it.  No
second model and no device work.  A learned draft model plugs in through
the same :class:`Drafter` interface (``InferenceEngine(...,
drafter=...)``).
"""
from __future__ import annotations

from typing import List, Sequence

__all__ = ["Drafter", "NGramDrafter"]


class Drafter:
    """Interface: propose up to `k` likely next tokens for a sequence.

    Implementations must be cheap relative to a fused device step and
    side-effect free per call (the scheduler may call them every step
    for every decode slot).  Returning ``[]`` is always legal — the
    slot decodes one token as usual that round."""

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        raise NotImplementedError

    def note_result(self, proposed: int, accepted: int) -> None:
        """Optional feedback hook (adaptive drafters); default no-op."""


class NGramDrafter(Drafter):
    """Suffix-match drafter over the request's own context.

    For n from ``max_ngram`` down to ``min_ngram``: take the sequence's
    trailing n-gram, find its most recent EARLIER occurrence, and
    propose the tokens that followed it.  Longest-suffix matches win
    (most specific evidence); the most recent occurrence wins among
    equals (locality).  O(len * max_ngram) per call with plain scans —
    sequences are serving-length (thousands), not corpus-length, so a
    suffix automaton would be overkill at this size."""

    def __init__(self, max_ngram: int = 4, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{min_ngram}/{max_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        toks = list(tokens)
        L = len(toks)
        if k < 1 or L < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            pat = toks[-n:]
            # most recent occurrence strictly before the suffix itself
            # (i + n <= L - 1, so the continuation is never empty)
            for i in range(L - n - 1, -1, -1):
                if toks[i:i + n] == pat:
                    # continuation of the earlier occurrence; when it
                    # runs off the end of the sequence, extrapolate the
                    # period (a greedy model stuck in a cycle repeats
                    # it — the highest-acceptance case, so draft the
                    # full k instead of truncating at the boundary)
                    period = L - n - i
                    out = []
                    for m in range(k):
                        q = i + n + m
                        if q < L:
                            out.append(toks[q])
                        else:
                            src = q - period
                            out.append(toks[src] if src < L
                                       else out[src - i - n])
                    return out
        return []
