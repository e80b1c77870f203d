"""Continuous-batching scheduler: admit/evict per step, slot packing,
token streaming (the single-engine core of
``mxnet_tpu/serve/scheduler.py``).

Requests arrive at any time, are admitted into a fixed set of **slots** as
soon as a slot AND enough KV pages are free, prefill in chunks beside other
slots' single-token decodes (one fused device step per iteration), stream
each generated token through a callback the moment it lands, and leave the
moment they finish.

Eviction (recompute preemption): when a growing sequence needs a page and
the pool is exhausted, the youngest-admitted OTHER active sequence is
evicted — its pages return to the free list and the request re-queues at
the FRONT with its prompt extended by everything it already generated.
On re-admission it re-prefills that prefix and continues; streamed tokens
are never re-emitted, and greedy streams stay identical to an
uninterrupted run.

The decode fast path: with ``ServeConfig.prefix_cache`` admission
attaches a cached prompt prefix by reference (`PrefixIndex.lookup`) and
skips its prefill; a page still shared when a step would write into it is
forked first (`_cow_guard`).  With ``spec_tokens=k`` every greedy slot
whose feed reaches the end of its sequence carries up to k drafted tokens;
the step's per-position argmax accepts the run of drafts that match it,
and the write cursor rolls back past the rest (`_trim_pages`).  Greedy
streams stay those of one-token decode.

QoS, the traffic journal, the scheduler's tracing and telemetry,
disaggregated handoff and fleet salvage wait for later slices (ROADMAP.md
queue A: A14 part 2, A15).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np

from ..base import MXNetError
from .kv_cache import NULL_PAGE

__all__ = ["ServeRequest", "ContinuousBatchingScheduler",
           "terminate_request", "expire_request", "deliver_token",
           "finish_request"]

_rid = itertools.count(1)


class ServeRequest:
    """One in-flight generation request (also the caller's handle).

    `on_token(token_id, request)` fires synchronously as each token is
    generated; `result()` blocks until completion and returns the full
    sequence (prompt + generated)."""

    def __init__(self, prompt, max_new_tokens: int, greedy: bool = True,
                 temperature: float = 1.0, eos_token_id: Optional[int] = None,
                 on_token: Optional[Callable] = None,
                 deadline_ms: float = 0.0):
        self.id = next(_rid)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.greedy = bool(greedy)
        self.temperature = float(temperature)
        self.eos_token_id = eos_token_id
        self.on_token = on_token
        #: wall-clock budget from submit (ms); 0 = unbounded
        self.deadline_ms = float(deadline_ms or 0.0)
        self.tokens: List[int] = []          # generated so far (streamed)
        self.state = "queued"                # queued|running|finished|failed
        self.evictions = 0
        #: prompt tokens served from the prefix cache (summed across
        #: re-admissions)
        self.prefix_hits = 0
        # serializes terminal transitions across threads
        self._terminate_lock = threading.Lock()
        self.submitted_ts = time.perf_counter()
        self.first_token_ts: Optional[float] = None
        self.finished_ts: Optional[float] = None
        self.error: Optional[str] = None
        self._done = threading.Event()

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.submitted_ts

    @property
    def latency_s(self) -> Optional[float]:
        if self.finished_ts is None:
            return None
        return self.finished_ts - self.submitted_ts

    def done(self) -> bool:
        return self._done.is_set()

    def deadline_due(self, now: Optional[float] = None) -> bool:
        """True when this request's wall-clock budget has lapsed."""
        if self.deadline_ms <= 0:
            return False
        now = time.perf_counter() if now is None else now
        return (now - self.submitted_ts) * 1e3 > self.deadline_ms

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} not finished")
        if self.state == "failed":
            raise MXNetError(f"request {self.id} failed: {self.error}")
        return list(self.prompt) + list(self.tokens)

    def _sequence(self) -> List[int]:
        """Tokens that must be in the KV cache: prompt + generated."""
        return self.prompt + self.tokens

    def __repr__(self):
        return (f"ServeRequest(id={self.id}, state={self.state}, "
                f"prompt={len(self.prompt)}t, generated="
                f"{len(self.tokens)}/{self.max_new_tokens})")


def terminate_request(req: ServeRequest, err: str) -> bool:
    """The one terminal path for every non-finished outcome: the first
    caller wins (marks the request failed, unblocks the waiter); every
    later attempt is a no-op returning False."""
    with req._terminate_lock:
        if req._done.is_set():
            return False
        req.state = "failed"
        req.error = err
        req.finished_ts = time.perf_counter()
        req._done.set()
    return True


def expire_request(req: ServeRequest, where: str) -> bool:
    """Deadline expiry: terminate with an error naming where the request
    was (queued/active)."""
    return terminate_request(
        req, f"deadline exceeded ({req.deadline_ms:g} ms) while {where}")


def deliver_token(req: ServeRequest, token: int) -> bool:
    """Mirror ONE streamed token onto a request handle: append, TTFT
    bookkeeping, the `on_token` callback.  Returns True when this token
    completed the request (``max_new_tokens`` reached or EOS)."""
    req.tokens.append(token)
    if req.first_token_ts is None:
        req.first_token_ts = time.perf_counter()
    if req.on_token is not None:
        try:
            req.on_token(token, req)
        except Exception:
            import logging
            logging.getLogger(__name__).exception(
                "serve: on_token callback failed (request %d)", req.id)
    return len(req.tokens) >= req.max_new_tokens or (
        req.eos_token_id is not None and token == req.eos_token_id)


def finish_request(req: ServeRequest) -> bool:
    """The one successful-completion terminal (first caller wins)."""
    with req._terminate_lock:
        if req._done.is_set():
            return False
        req.state = "finished"
        req.finished_ts = time.perf_counter()
        req._done.set()
    return True


class _Slot:
    """One occupied batch slot: the request plus its KV page table."""

    def __init__(self, req: ServeRequest, slot_idx: int, max_pages: int,
                 admit_seq: int):
        self.req = req
        self.slot_idx = slot_idx
        self.pages: List[int] = []
        self.table = np.zeros(max_pages, np.int32)   # NULL_PAGE fill
        self.ctx = 0          # tokens already written to the pool
        self.admit_seq = admit_seq    # admission order (eviction priority)
        # prompt blocks registered in the engine's PrefixIndex (once, when
        # the prompt's prefill completes)
        self.prefix_inserted = False


class ContinuousBatchingScheduler:
    """Drives admission, per-step batch packing, eviction, streaming.

    Owned by an `InferenceEngine`; `step()` runs one fused device step
    over the current actives.  `submit` is thread-safe; stepping is
    single-threaded by design (one device stream)."""

    def __init__(self, engine):
        self.engine = engine
        cfg = engine.serve_config
        self.max_slots = cfg.max_slots
        self.page_size = cfg.page_size
        self.prefill_chunk = cfg.prefill_chunk
        self.deadline_ms = float(cfg.deadline_ms or 0)
        self.max_len = engine.max_len
        self.max_pages_per_seq = engine.max_pages_per_seq
        self.allocator = engine.allocator
        self._queue: deque = deque()
        self._slots: List[Optional[_Slot]] = [None] * self.max_slots
        self._lock = threading.Lock()
        self._admit_seq = itertools.count()
        #: drain mode: submit/enqueue refuse new work; evicted actives
        #: still re-admit so every active stream runs to completion
        self.draining = False
        self._steps = 0
        # decode-fast-path accounting (`spec_stats`)
        self.spec_proposed = 0       # draft tokens fed for verification
        self.spec_accepted = 0       # draft tokens that matched greedy
        self.tokens_emitted = 0      # tokens streamed (all requests)
        self.prefix_hit_tokens = 0   # prompt tokens attached from cache
        self.cow_forks = 0           # shared pages forked before a write

    # ------------------------------------------------------------------
    def validate_request(self, prompt, max_new_tokens: int) -> List[int]:
        """Normalize + validate a prompt against this scheduler's caps
        (context length, whole-pool fit).  Raises for a request that could
        NEVER be served.  Returns the normalized token list."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise MXNetError("empty prompt")
        if int(max_new_tokens) < 1:
            raise MXNetError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        total = len(prompt) + int(max_new_tokens)
        if total > self.max_len:
            raise MXNetError(
                f"request needs {total} tokens but the serving context "
                f"cap is {self.max_len} (MXTPU_SERVE_MAX_LEN / model "
                f"max_position)")
        need = self.allocator.pages_for(total)
        if need > self.allocator.total_pages:
            raise MXNetError(
                f"request needs {need} KV pages but the pool only has "
                f"{self.allocator.total_pages} — raise MXTPU_SERVE_PAGES")
        return prompt

    def submit(self, prompt, max_new_tokens: int = 20, greedy: bool = True,
               temperature: float = 1.0, eos_token_id=None,
               on_token=None, deadline_ms: Optional[float] = None
               ) -> ServeRequest:
        prompt = self.validate_request(prompt, max_new_tokens)
        req = ServeRequest(prompt, max_new_tokens, greedy=greedy,
                           temperature=temperature,
                           eos_token_id=eos_token_id, on_token=on_token,
                           deadline_ms=(self.deadline_ms
                                        if deadline_ms is None
                                        else deadline_ms))
        self.enqueue(req)
        return req

    def enqueue(self, req: ServeRequest, front: bool = False) -> None:
        """Queue an existing request.  One that already generated tokens
        re-enters like an evicted one: `_sequence()` folds them into the
        prefix the next prefill recomputes."""
        req.state = "queued"
        with self._lock:
            if self.draining:
                raise MXNetError("engine is draining and not accepting "
                                 "requests")
            if front:
                self._queue.appendleft(req)
            else:
                self._queue.append(req)

    def detach_queued(self) -> List[ServeRequest]:
        """Remove and return every QUEUED request (none hold pages)."""
        with self._lock:
            out = list(self._queue)
            self._queue.clear()
        return out

    # ------------------------------------------------------------------
    def _free_slot_idx(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """`PageAllocator.alloc` with prefix-cache pressure relief: on a
        shortfall, LRU-evict unreferenced prefix-cache entries to cover
        it, then retry once.  Cached-but-unused prefixes always yield to
        live sequences."""
        if n <= 0:
            return []
        pages = self.allocator.alloc(n)
        if pages is not None:
            return pages
        index = self.engine.prefix_index
        if index is None:
            return None
        index.evict_pages(n - self.allocator.free_pages)
        return self.allocator.alloc(n)

    def _admit(self) -> None:
        """FIFO admission under memory backpressure: a request enters a
        slot only when its CURRENT sequence (prompt + already-generated,
        for re-admits) plus one decode page fits the free list — partial
        admission would deadlock against other growing sequences.

        With the prefix cache on, admission first consults the
        `PrefixIndex`: cached prompt-prefix pages are ATTACHED by
        reference and the matching prefill chunks are skipped — the
        slot's write cursor starts past them.  The match is capped at
        ``len(sequence) - 1`` so the last token is always re-fed (its
        forward pass gives the next token's logits)."""
        while True:
            with self._lock:
                if not self._queue:
                    return
                idx = self._free_slot_idx()
                if idx is None:
                    return
                req = self._queue[0]
                seq = req._sequence()
                index = self.engine.prefix_index
                attached, hit = ([], 0)
                if index is not None:
                    attached, hit = index.lookup(seq[:-1])
                need = self.allocator.pages_for(len(seq) + 1)
                pages = self._alloc_pages(need - len(attached))
                if pages is None:
                    # OOM backpressure: wait for frees (the attached pages
                    # go back; the index keeps its own reference, so the
                    # next attempt re-attaches)
                    if attached:
                        self.allocator.free(attached)
                    return
                self._queue.popleft()
                slot = _Slot(req, idx, self.max_pages_per_seq,
                             next(self._admit_seq))
                slot.pages = attached + pages
                slot.table[:len(slot.pages)] = slot.pages
                slot.ctx = hit
                self._slots[idx] = slot
            req.state = "running"
            req.prefix_hits += hit
            self.prefix_hit_tokens += hit

    def _release_slot(self, slot: _Slot) -> None:
        """Recycle a slot's KV pages and vacate it — the one way any
        request leaves the active set."""
        self.allocator.free(slot.pages)
        self._slots[slot.slot_idx] = None

    def _evict(self, slot: _Slot) -> None:
        """Recompute preemption: free the slot's pages, re-queue the
        request at the FRONT with its generated tokens folded into the
        prefix it will re-prefill."""
        req = slot.req
        self._release_slot(slot)
        req.state = "queued"
        req.evictions += 1
        with self._lock:
            self._queue.appendleft(req)

    def _ensure_capacity(self, slot: _Slot, upto_tokens: int) -> bool:
        """Grow `slot`'s page table to hold `upto_tokens`, evicting
        younger actives when the free list runs dry.  Returns False when
        even eviction cannot help (the slot itself must yield)."""
        need_total = self.allocator.pages_for(upto_tokens)
        while len(slot.pages) < need_total:
            got = self._alloc_pages(1)
            if got is not None:
                slot.table[len(slot.pages)] = got[0]
                slot.pages.extend(got)
                continue
            victims = [s for s in self._slots
                       if s is not None and s is not slot]
            if not victims:
                return False
            victims.sort(key=lambda s: s.admit_seq)
            self._evict(victims[-1])
        return True

    def _cow_guard(self, slot: _Slot, first: int, last: int) -> bool:
        """Copy-on-write before the fused step writes token positions
        ``[first, last]``: any page in that range still SHARED (attached
        from the prefix cache, or registered in it by this slot's own
        prompt) is forked — a fresh page allocated, its contents copied on
        the device (`InferenceEngine.copy_page`), the table repointed and
        the shared original left to its other owners — so a write never
        reaches KV another sequence (or the cache) reads.  False when the
        pool cannot supply a fork page even after prefix-cache eviction
        (the caller evicts this slot)."""
        ps = self.page_size
        for pg in range(first // ps, last // ps + 1):
            page = int(slot.table[pg])
            if self.allocator.refcount(page) <= 1:
                continue
            got = self.allocator.fork(page)
            if got is None:
                index = self.engine.prefix_index
                if index is not None and index.evict_pages(1):
                    got = self.allocator.fork(page)
                if got is None:
                    return False
            new, copied = got
            if copied:
                self.engine.copy_page(page, new)
                slot.table[pg] = new
                slot.pages[pg] = new
                self.cow_forks += 1
        return True

    def _trim_pages(self, slot: _Slot) -> None:
        """Roll back pages past the slot's write cursor (after rejected
        drafts), keeping the page the next decode token lands in.  They
        were freshly allocated (attached prefix pages always sit below the
        cursor), so they go straight back to the free list."""
        keep = max(1, self.allocator.pages_for(slot.ctx + 1))
        if len(slot.pages) <= keep:
            return
        extra = slot.pages[keep:]
        del slot.pages[keep:]
        slot.table[keep:keep + len(extra)] = NULL_PAGE
        self.allocator.free(extra)

    def _expire_deadlines(self) -> None:
        """Fail every queued/active request past its per-request deadline
        and recycle its pages."""
        now = time.perf_counter()
        with self._lock:
            dead = [r for r in self._queue if r.deadline_due(now)]
            if dead:
                gone = set(id(r) for r in dead)
                self._queue = deque(r for r in self._queue
                                    if id(r) not in gone)
        for req in dead:
            expire_request(req, "queued")
        for slot in list(self._slots):
            if slot is not None and slot.req.deadline_due(now):
                self._release_slot(slot)
                expire_request(slot.req, "active")

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """Run one fused serving step over the active slots.  Returns
        False when there was nothing to do (no actives, empty queue)."""
        self._expire_deadlines()
        self._admit()
        actives = [s for s in self._slots if s is not None]
        if not actives:
            return False

        # plan the chunk width: any slot with >1 pending token prefills, so
        # the step runs at the prefill chunk width; a pure-decode round
        # runs the C=1 step — unless the drafter proposed tokens, and then
        # the k+1 verification width
        pending = {s.slot_idx: len(s.req._sequence()) - s.ctx
                   for s in actives}
        any_prefill = any(p > 1 for p in pending.values())

        # speculative drafts: any GREEDY slot whose feed reaches the end of
        # its sequence this round (pure decode, or the last prefill chunk
        # with spare width) carries up to k proposed tokens after its real
        # feed, verified by the same launch
        spec_k = self.engine.serve_config.spec_tokens
        drafter = self.engine.drafter
        proposals = {}
        if spec_k > 0 and drafter is not None:
            cmax = self.prefill_chunk if any_prefill else spec_k + 1
            for s in actives:
                req = s.req
                p = pending[s.slot_idx]
                if not req.greedy or not 1 <= p <= cmax - 1:
                    continue
                seq = req._sequence()
                k_eff = min(spec_k, cmax - p,
                            req.max_new_tokens - len(req.tokens) - 1,
                            self.max_len - len(seq))
                if k_eff <= 0:
                    continue
                d = drafter.propose(seq, k_eff)
                if d:
                    proposals[s.slot_idx] = [int(t) for t in d[:k_eff]]
        if any_prefill:
            C = self.prefill_chunk
        elif proposals:
            C = spec_k + 1
        else:
            C = 1

        # capacity: every slot must hold its chunk's tokens (drafts
        # included — rejected ones roll back after verification); slots
        # that cannot (even after evicting younger actives) are evicted
        # themselves this round.  The COW guard then forks any still-shared
        # page in the write range before the step writes into it.
        for s in sorted(actives, key=lambda s: s.admit_seq):
            if self._slots[s.slot_idx] is not s:
                continue      # already evicted by a victim search
            nt = min(pending[s.slot_idx], C) \
                + len(proposals.get(s.slot_idx, ()))
            if not self._ensure_capacity(s, s.ctx + nt) or \
                    not self._cow_guard(s, s.ctx, s.ctx + nt - 1):
                self._evict(s)
        actives = [s for s in self._slots if s is not None]
        if not actives:
            return False

        B = self.max_slots
        tok = np.zeros((B, C), np.int32)
        num_tokens = np.zeros(B, np.int32)
        start_pos = np.zeros(B, np.int32)
        tables = np.zeros((B, self.max_pages_per_seq), np.int32)
        ctx_lens = np.zeros(B, np.int32)
        temps = np.ones(B, np.float32)
        greedy = np.ones(B, bool)
        plan = {}
        for s in actives:
            seq = s.req._sequence()
            nt_seq = min(len(seq) - s.ctx, C)
            draft = proposals.get(s.slot_idx, []) \
                if s.ctx + nt_seq == len(seq) else []
            feed = seq[s.ctx:s.ctx + nt_seq] + draft
            nt = len(feed)
            i = s.slot_idx
            tok[i, :nt] = feed
            num_tokens[i] = nt
            start_pos[i] = s.ctx
            tables[i] = s.table
            ctx_lens[i] = s.ctx + nt
            temps[i] = s.req.temperature
            greedy[i] = s.req.greedy
            # the step's logits are a new token only when the feed
            # reaches the end of the sequence (mid-prefill: discarded)
            plan[i] = {"feed": feed, "nt": nt, "nt_seq": nt_seq,
                       "ctx0": s.ctx, "draft": len(draft),
                       "consume": s.ctx + nt_seq == len(seq)}
            s.ctx += nt

        try:
            next_tokens, all_tok = self.engine._execute(
                tok, num_tokens, start_pos, tables, ctx_lens, temps,
                greedy, C)
        except Exception as exc:
            # a failed device step is unrecoverable for every in-flight
            # sequence: fail them all (waiters unblock with the error)
            self._fail_all(exc)
            raise
        self._steps += 1

        # register just-prefilled prompts in the prefix cache BEFORE
        # emitting (an emit can finish a request and release its pages):
        # the slot's pages hold the complete prompt KV once the write
        # cursor passed the prompt
        index = self.engine.prefix_index
        if index is not None:
            for s in actives:
                if s.prefix_inserted or self._slots[s.slot_idx] is not s:
                    continue
                if s.ctx >= len(s.req.prompt):
                    index.insert(s.req.prompt, s.pages)
                    s.prefix_inserted = True

        # distribute tokens in admission order (stable streaming).  A
        # speculating slot emits its whole accepted run — the fed
        # position's greedy token, then each draft that matched it — and
        # rolls its write cursor back past the rejected rest.
        for s in sorted(actives, key=lambda s: s.admit_seq):
            i = s.slot_idx
            pl = plan[i]
            if not pl["consume"] or self._slots[i] is not s:
                continue
            if all_tok is None or not s.req.greedy:
                self._emit(s, int(next_tokens[i]))
                self.tokens_emitted += 1
                continue
            feed, nt = pl["feed"], pl["nt"]
            # all_tok column t holds fed position nt - T + t
            T = all_tok.shape[1]
            emitted = 0
            for j in range(pl["nt_seq"] - 1, nt):
                tokj = int(all_tok[i, j - nt + T])
                self._emit(s, tokj)
                emitted += 1
                if self._slots[i] is not s or s.req.done():
                    break      # finished (max_new / eos)
                if j + 1 < nt and feed[j + 1] != tokj:
                    break      # draft rejected: stop the run
            self.tokens_emitted += emitted
            self.spec_proposed += pl["draft"]
            self.spec_accepted += emitted - 1
            if pl["draft"] and drafter is not None:
                drafter.note_result(pl["draft"], emitted - 1)
            if self._slots[i] is s:
                # roll back past rejected drafts: the cursor returns to the
                # last ACCEPTED token's position and the pages holding
                # only rejected KV go back to the free list
                s.ctx = pl["ctx0"] + pl["nt_seq"] + emitted - 1
                self._trim_pages(s)
        return True

    def _emit(self, slot: _Slot, token: int) -> None:
        if deliver_token(slot.req, token):
            self._finish(slot)

    def _finish(self, slot: _Slot) -> None:
        self._release_slot(slot)
        finish_request(slot.req)

    def _fail_all(self, exc: BaseException) -> None:
        """Terminal cleanup after a failed device step: every active AND
        queued request fails."""
        err = f"{type(exc).__name__}: {exc}"
        for slot in list(self._slots):
            if slot is not None:
                self._release_slot(slot)
                terminate_request(slot.req, err)
        with self._lock:
            queued, self._queue = list(self._queue), deque()
        for req in queued:
            terminate_request(req, err)

    # ------------------------------------------------------------------
    def run_until_idle(self, max_steps: int = 100000) -> int:
        """Pump `step()` until queue and slots drain; returns steps run."""
        n = 0
        while n < max_steps:
            if not self.step():
                with self._lock:
                    if not self._queue:
                        break
            n += 1
        return n

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def active_count(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def spec_stats(self) -> dict:
        """Decode-fast-path accounting: speculation accept rate, tokens a
        fused step, prefix-cache hits, COW forks."""
        steps = max(1, self._steps)
        return {
            "proposed": self.spec_proposed,
            "accepted": self.spec_accepted,
            "accept_rate": (round(self.spec_accepted
                                  / self.spec_proposed, 4)
                            if self.spec_proposed else None),
            "steps": self._steps,
            "tokens": self.tokens_emitted,
            "tokens_per_step": round(self.tokens_emitted / steps, 4),
            "steps_per_token": (round(self._steps
                                      / self.tokens_emitted, 4)
                                if self.tokens_emitted else None),
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "cow_forks": self.cow_forks,
            "kv_pages_shared": self.allocator.shared_pages(),
        }
