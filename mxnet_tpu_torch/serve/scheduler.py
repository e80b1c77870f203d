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

QoS, the traffic journal, tracing, telemetry, speculative drafts, the
prefix cache with copy-on-write, disaggregated handoff and fleet salvage
wait for later slices (ROADMAP.md queue C).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np

from ..base import MXNetError

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

    def _admit(self) -> None:
        """FIFO admission under memory backpressure: a request enters a
        slot only when its CURRENT sequence (prompt + already-generated,
        for re-admits) plus one decode page fits the free list — partial
        admission would deadlock against other growing sequences."""
        while True:
            with self._lock:
                if not self._queue:
                    return
                idx = self._free_slot_idx()
                if idx is None:
                    return
                req = self._queue[0]
                need = self.allocator.pages_for(len(req._sequence()) + 1)
                pages = self.allocator.alloc(need)
                if pages is None:
                    return           # OOM backpressure: wait for frees
                self._queue.popleft()
                slot = _Slot(req, idx, self.max_pages_per_seq,
                             next(self._admit_seq))
                slot.pages = pages
                slot.table[:len(pages)] = pages
                self._slots[idx] = slot
            req.state = "running"

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
            got = self.allocator.alloc(1)
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

        # any slot with >1 pending token prefills, so the step runs at the
        # prefill chunk width; a pure-decode round runs the C=1 step
        pending = {s.slot_idx: len(s.req._sequence()) - s.ctx
                   for s in actives}
        C = self.prefill_chunk if any(p > 1 for p in pending.values()) \
            else 1

        # capacity: every slot must hold its chunk's tokens; slots that
        # cannot (even after evicting younger actives) yield this round
        for s in sorted(actives, key=lambda s: s.admit_seq):
            if self._slots[s.slot_idx] is not s:
                continue      # already evicted by a victim search
            if not self._ensure_capacity(
                    s, s.ctx + min(pending[s.slot_idx], C)):
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
        consume = {}
        for s in actives:
            seq = s.req._sequence()
            nt = min(len(seq) - s.ctx, C)
            i = s.slot_idx
            tok[i, :nt] = seq[s.ctx:s.ctx + nt]
            num_tokens[i] = nt
            start_pos[i] = s.ctx
            tables[i] = s.table
            ctx_lens[i] = s.ctx + nt
            temps[i] = s.req.temperature
            greedy[i] = s.req.greedy
            # the step's logits are a new token only when the feed
            # reaches the end of the sequence (mid-prefill: discarded)
            consume[i] = s.ctx + nt == len(seq)
            s.ctx += nt

        try:
            next_tokens = self.engine._execute(
                tok, num_tokens, start_pos, tables, ctx_lens, temps,
                greedy, C)
        except Exception as exc:
            # a failed device step is unrecoverable for every in-flight
            # sequence: fail them all (waiters unblock with the error)
            self._fail_all(exc)
            raise

        # distribute tokens in admission order (stable streaming)
        for s in sorted(actives, key=lambda s: s.admit_seq):
            i = s.slot_idx
            if not consume[i] or self._slots[i] is not s:
                continue
            self._emit(s, int(next_tokens[i]))
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
