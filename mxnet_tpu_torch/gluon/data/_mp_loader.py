"""Multiprocessing DataLoader workers with shared-memory batch transport
(counterpart of ``mxnet_tpu/gluon/data/_mp_loader.py``: the same pool,
supervision and segment names).

Parity: the reference's process-pool DataLoader ships NDArrays between
worker processes and the trainer through POSIX shared memory
(`python/mxnet/gluon/data/dataloader.py:123-138,187,514` ForkingPickler +
`src/storage/cpu_shared_storage_manager.h`).  The port's equivalent:

- workers are **spawned** (not forked): a forked child would inherit the
  parent's CUDA context, which is not fork-safe.  Each spawned worker
  pins its process to the CPU (`device.pin_process_cpu`) *before*
  anything is unpickled, so arrays pickled from the card are rebuilt on
  the CPU and dataset transforms written against `mx.np` run there: no
  worker ever opens a CUDA context.
- the dataset/batchify closure crosses once, at pool startup, as an opaque
  pickle blob deserialised only after the CPU pin (ndarrays pickle via
  their numpy values).
- finished batches cross as NumPy: each array leaf is written to a
  `multiprocessing.shared_memory` segment; the parent maps it, wraps it in
  an `mx.np` array on its current device (one host→device copy — the
  reference's pinned-memory role), and unlinks the segment.

The parent preserves batch order (a reorder buffer keyed on batch id) and
bounds each wait with the loader timeout, like the thread-pool path.

Supervision: each worker has its own task queue AND its own result
queue, so the parent knows exactly which batch ids are in flight where.
`ProcessPool.get` polls every worker's result queue in short slices and
checks worker liveness on each empty round, so a worker killed by the
OOM killer (or a segfaulting native transform) is detected immediately —
not after the full timeout with a misleading "transform is stuck" error.
Dead workers are respawned and their in-flight batches resubmitted, a
bounded number of times (`max_respawns`), before a precise error naming
the dead worker and its exit code is raised. Workers name their segments
``mxtpu_torch-<pid>-<seq>`` so the parent can reclaim a killed worker's
half-shipped segments from ``/dev/shm`` instead of leaking them (the JAX
package's are ``mxtpu-<pid>-<seq>``: neither package's cleanup or leak
check sees the other's).

Why per-worker RESULT queues (not one shared queue): a
``multiprocessing.Queue`` serializes writers through a cross-process
write lock, and SIGKILL can land while the victim's feeder thread HOLDS
it — the lock is then held forever, every surviving worker blocks in
``put``, and the parent times out with "all workers alive" while their
finished segments pile up in /dev/shm (the exact flake
``test_mp_dataloader_survives_sigkilled_worker`` showed when its file
ran whole).  With one queue per worker a killed writer can only wedge
its OWN queue, which is discarded with it; its in-flight batches are
resubmitted to the respawn's fresh queue and everyone else keeps
delivering.
"""
from __future__ import annotations

import itertools
import logging
import os
import pickle
import queue as _queue_mod
import time
from typing import Any, Callable, List

import numpy as _onp

from ... import telemetry as _tele
from ...ndarray.ndarray import ndarray

__all__ = ["ProcessPool"]

_log = logging.getLogger(__name__)

# liveness poll granularity inside get(): bounds dead-worker detection
# latency without busy-waiting
_POLL = 0.1

_SHM_PREFIX = "mxtpu_torch-"
_shm_seq = itertools.count()


class _SegmentLost(Exception):
    """A batch's shared-memory segment vanished before the parent mapped
    it — its producer died mid-delivery and the cleanup reclaimed the
    segment. The batch was resubmitted; this copy is droppable."""


def _new_segment(nbytes: int):
    """Create a segment named ``mxtpu_torch-<pid>-<seq>`` (not the anonymous
    psm_* default) so the parent can reclaim this process's in-flight
    segments by pid if it dies."""
    from multiprocessing import shared_memory
    while True:
        name = f"{_SHM_PREFIX}{os.getpid()}-{next(_shm_seq)}"
        try:
            return shared_memory.SharedMemory(name=name, create=True,
                                              size=nbytes)
        except FileExistsError:   # stale name from a previous incarnation
            continue


def _cleanup_worker_shm(pid) -> List[str]:
    """Unlink every segment a (dead) worker pid left in /dev/shm. Only
    touches our ``mxtpu_torch-<pid>-*`` namespace; segments for batches the
    parent already received were materialised + unlinked at receipt, so
    whatever is left is orphaned by construction."""
    base = "/dev/shm"
    removed: List[str] = []
    if pid is None or not os.path.isdir(base):
        return removed
    prefix = f"{_SHM_PREFIX}{pid}-"
    for fn in os.listdir(base):
        if fn.startswith(prefix):
            try:
                os.unlink(os.path.join(base, fn))
                removed.append(fn)
            except OSError:
                pass
    return removed


# ---------------------------------------------------------------------------
# tree <-> shared-memory descriptors
# ---------------------------------------------------------------------------

def _to_shm(obj, segments):
    """Replace array leaves with shared-memory descriptors (recursive)."""
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_shm(o, segments) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_shm(v, segments) for k, v in obj.items()}
    arr = None
    if isinstance(obj, _onp.ndarray):
        arr = obj
    elif isinstance(obj, ndarray):           # mx ndarray leaf
        arr = obj.asnumpy()
    if arr is None:
        return ("py", obj)
    arr = _onp.ascontiguousarray(arr)
    if arr.nbytes == 0:
        return ("npz", arr.shape, arr.dtype.str)
    shm = _new_segment(arr.nbytes)
    shm.buf[:arr.nbytes] = arr.tobytes()
    segments.append(shm)
    return ("shm", shm.name, arr.shape, arr.dtype.str)


def _from_shm(spec, to_array: Callable[[_onp.ndarray], Any]):
    """Rebuild the batch tree in the parent; unlinks each segment."""
    from multiprocessing import shared_memory
    if isinstance(spec, tuple) and spec and spec[0] == "py":
        return spec[1]
    if isinstance(spec, tuple) and spec and spec[0] == "npz":
        _, shape, dtype = spec
        return to_array(_onp.empty(shape, _onp.dtype(dtype)))
    if isinstance(spec, tuple) and spec and spec[0] == "shm":
        _, name, shape, dtype = spec
        try:
            shm = shared_memory.SharedMemory(name=name)
        except FileNotFoundError:
            raise _SegmentLost(name)
        try:
            view = _onp.ndarray(shape, _onp.dtype(dtype), buffer=shm.buf)
            # one explicit host copy: the CPU backend's device_put may
            # zero-copy-alias its input, which must outlive the segment
            out = to_array(view.copy())
        finally:
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
        return out
    if isinstance(spec, (tuple, list)):
        return type(spec)(_from_shm(s, to_array) for s in spec)
    if isinstance(spec, dict):
        return {k: _from_shm(v, to_array) for k, v in spec.items()}
    return spec


def _map_arrays(tree, fn):
    """Apply `fn` to every numpy leaf of an already-materialised batch,
    walking tuples (named ones too), lists and dicts; non-array leaves —
    the "py" scalars — pass through untouched."""
    if isinstance(tree, _onp.ndarray):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_arrays(x, fn) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_arrays(x, fn) for x in tree)
    if isinstance(tree, dict):
        return {k: _map_arrays(v, fn) for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------

def _worker_main(blob: bytes, task_q, data_q):
    """Worker entry. `blob` is deserialised only after the CPU pin so the
    dataset's ndarrays (and any transform's mx ops) live on the CPU —
    never on the card, whose context stays the parent's alone."""
    from mxnet_tpu_torch.device import pin_process_cpu
    pin_process_cpu()
    if os.environ.get("MXTPU_FAULT_SPEC"):
        # the fault points are armed in this process too
        from mxnet_tpu_torch.resilience import (EXIT_CODE, FaultExit,
                                                fault_point)
    else:
        EXIT_CODE, FaultExit = 0, ()   # empty tuple: matches no exception

        def fault_point(name):
            return None
    dataset, batchify_fn = pickle.loads(blob)
    from multiprocessing import resource_tracker
    while True:
        task = task_q.get()
        if task is None:
            return
        batch_id, indices = task
        segments = []
        try:
            fault_point("worker_exec")
            samples = [dataset[i] for i in indices]
            batch = batchify_fn(samples)
            spec = _to_shm(batch, segments)
            for shm in segments:
                shm.close()
                # ownership transfers to the parent (which unlinks after
                # copying); unregister so this process's resource tracker
                # doesn't destroy — or warn about — the in-flight segment
                try:
                    resource_tracker.unregister(shm._name, "shared_memory")
                except Exception:
                    pass
            data_q.put((batch_id, spec, None))
        except FaultExit:
            # injected process death: flush results already delivered
            # (join the feeder thread), then die like a killed process
            data_q.close()
            data_q.join_thread()
            os._exit(EXIT_CODE)
        except Exception as e:  # ship the failure instead of dying silently
            import traceback
            # a failure mid-_to_shm (e.g. /dev/shm full) leaves created
            # segments linked; the parent never learns their names and
            # this worker stays alive, so reclaim them here or they leak
            # — compounding the very out-of-shm condition that failed us
            for shm in segments:
                try:        # unlink first: close() may raise if already
                    shm.unlink()   # closed on the success path above
                except Exception:
                    pass
                try:
                    shm.close()
                except Exception:
                    pass
            data_q.put((batch_id, None,
                        f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))


class _Worker:
    """Parent-side handle: process + private task/result queues +
    in-flight ids."""

    __slots__ = ("idx", "proc", "task_q", "data_q", "assigned")

    def __init__(self, idx, proc, task_q, data_q):
        self.idx = idx
        self.proc = proc
        self.task_q = task_q
        self.data_q = data_q
        self.assigned = set()


class ProcessPool:
    """Order-preserving, supervised process pool:
    submit(indices) -> batches in order, surviving worker death."""

    def __init__(self, dataset, batchify_fn, num_workers: int,
                 max_respawns: int = None):
        import multiprocessing as mp
        self._ctx = mp.get_context("spawn")
        self._blob = pickle.dumps((dataset, batchify_fn),
                                  protocol=pickle.HIGHEST_PROTOCOL)
        self._workers = [self._spawn(i) for i in range(num_workers)]
        self._max_respawns = (2 * num_workers if max_respawns is None
                              else max_respawns)
        self._respawns_left = self._max_respawns
        self._next_submit = 0
        self._next_yield = 0
        self._reorder = {}    # batch_id -> materialised numpy tree
        self._pending = {}    # batch_id -> indices (for resubmission)
        self._owner = {}      # batch_id -> _Worker
        self._failed = set()  # errored out-of-order ids, already raised
        self._closed = False

    def _spawn(self, idx: int) -> _Worker:
        task_q = self._ctx.Queue()
        # private result queue: a SIGKILL mid-put can strand this
        # queue's write lock, but only THIS worker writes to it — the
        # queue dies with the worker and nobody else wedges
        data_q = self._ctx.Queue()
        proc = self._ctx.Process(
            target=_worker_main, args=(self._blob, task_q, data_q),
            daemon=True, name=f"mxtpu-dl-worker-{idx}")
        proc.start()
        return _Worker(idx, proc, task_q, data_q)

    def submit(self, indices) -> None:
        indices = list(indices)
        # least-loaded assignment; in-flight tracking is what makes the
        # dead-worker resubmission exact
        w = min(self._workers, key=lambda w: (len(w.assigned), w.idx))
        bid = self._next_submit
        self._next_submit += 1
        self._pending[bid] = indices
        self._owner[bid] = w
        w.assigned.add(bid)
        w.task_q.put((bid, indices))

    @property
    def outstanding(self) -> int:
        return self._next_submit - self._next_yield

    # -- supervision -----------------------------------------------------
    def _check_workers(self, resubmit: bool = True):
        """Detect dead workers (exitcode set); reclaim their segments and
        respawn them. With `resubmit` (the get() path) their in-flight
        batches are resubmitted and the respawn consumes budget — raising
        once it is exhausted. Without (the reset() path) the batches are
        being discarded anyway, so the replacement is free: an
        epoch-boundary respawn is housekeeping, not failure recovery.
        Returns (respawned, lost_ids)."""
        respawned = False
        abandoned = set()
        for slot, w in enumerate(self._workers):
            if w.proc.exitcode is None:
                continue
            code = w.proc.exitcode
            lost = sorted(w.assigned)
            leaked = _cleanup_worker_shm(w.proc.pid)
            if leaked:
                _log.warning("reclaimed %d shm segment(s) from dead "
                             "worker %d: %s", len(leaked), w.idx, leaked)
            if resubmit and self._respawns_left <= 0:
                from ...base import MXNetError
                raise MXNetError(
                    f"DataLoader worker {w.idx} (pid {w.proc.pid}) died "
                    f"with exit code {code} and the respawn budget "
                    f"({self._max_respawns}) is exhausted; in-flight "
                    f"batches {lost} are lost. Repeated worker deaths "
                    f"usually mean the OOM killer (shrink the batch or "
                    f"num_workers) or a crashing native transform.")
            if resubmit:
                self._respawns_left -= 1
            if _tele.enabled():
                _tele.counter(
                    "dataloader_worker_deaths",
                    "DataLoader worker processes that died (OOM kill, "
                    "crash, injected fault)").inc()
                _tele.event("worker_death", worker=w.idx, pid=w.proc.pid,
                            exit_code=code, lost_batches=lost)
            _log.warning(
                "DataLoader worker %d (pid %s) died with exit code %s; "
                "respawning (%s batches %s; %d/%d respawns left)",
                w.idx, w.proc.pid, code,
                "resubmitting" if resubmit else "abandoning", lost,
                self._respawns_left, self._max_respawns)
            # the dead worker's result queue goes with it: a SIGKILL
            # mid-put may have corrupted its stream (or stranded its
            # write lock), and every batch it still owed is resubmitted
            # below — duplicates from a drained queue would be discarded
            # anyway, so nothing of value is lost with it
            try:
                w.data_q.close()
            except Exception:
                pass
            neww = self._spawn(w.idx)
            self._workers[slot] = neww
            if _tele.enabled():
                _tele.counter(
                    "dataloader_respawns",
                    "Dead DataLoader workers transparently respawned"
                ).inc()
                _tele.event("worker_respawn", worker=w.idx,
                            pid=neww.proc.pid,
                            resubmitted=lost if resubmit else [])
            for bid in lost:
                if resubmit:
                    self._owner[bid] = neww
                    neww.assigned.add(bid)
                    neww.task_q.put((bid, self._pending[bid]))
                else:
                    self._owner.pop(bid, None)
                    self._pending.pop(bid, None)
                    abandoned.add(bid)
            respawned = True
        return respawned, abandoned

    def _receive(self, batch_id, spec, err, raise_errors: bool = True):
        """Fold one result-queue item into the reorder buffer. Duplicates
        (a worker delivered, died before we read it, and the batch was
        recomputed) are discarded; lost segments mean the recomputed copy
        is still coming, so bookkeeping is left intact for it."""
        from ...base import MXNetError
        if batch_id < self._next_yield or batch_id in self._reorder:
            if spec is not None:
                self._discard(spec)
            return
        if err is not None:
            w = self._owner.pop(batch_id, None)
            if w is not None:
                w.assigned.discard(batch_id)
            self._pending.pop(batch_id, None)
            # mark the failed batch consumed so a caller that catches the
            # error (or a later epoch) doesn't wait on it forever — an
            # OUT-OF-ORDER error is remembered and skipped when the yield
            # pointer reaches it
            if batch_id == self._next_yield:
                self._next_yield += 1
                self._skip_failed()
            else:
                self._failed.add(batch_id)
            if raise_errors:
                raise MXNetError(f"DataLoader worker failed: {err}")
            return
        try:
            # materialise NOW (host copy + unlink): once a batch is in the
            # reorder buffer it no longer depends on any shm segment, so a
            # later producer death can't invalidate buffered batches
            tree = _from_shm(spec, lambda a: a)
        except _SegmentLost:
            return
        w = self._owner.pop(batch_id, None)
        if w is not None:
            w.assigned.discard(batch_id)
        self._pending.pop(batch_id, None)
        self._reorder[batch_id] = tree

    def _skip_failed(self) -> None:
        """Advance the yield pointer past ids whose error was already
        delivered (they will never be produced)."""
        while self._next_yield in self._failed:
            self._failed.discard(self._next_yield)
            self._next_yield += 1

    def _poll_queues(self, raise_errors: bool = True) -> bool:
        """Drain whatever every live worker has delivered (non-blocking
        round over the per-worker result queues).  Returns True when at
        least one item was folded in."""
        got = False
        for w in list(self._workers):
            while True:
                try:
                    item = w.data_q.get_nowait()
                except _queue_mod.Empty:
                    break
                except (OSError, ValueError):
                    break      # queue torn down under us (worker died)
                self._receive(*item, raise_errors=raise_errors)
                got = True
        return got

    def _wait_any(self, timeout: float) -> None:
        """Block until ANY worker's result queue has data (or `timeout`
        lapses) — arrival-triggered wakeup, so a batch landing 5 ms
        into the wait is consumed at 5 ms, not at the next fixed poll
        tick.  Falls back to a short sleep if the queues' reader
        connections are unavailable (non-CPython Queue internals)."""
        try:
            from multiprocessing.connection import wait as _conn_wait
            readers = [w.data_q._reader for w in self._workers]
            _conn_wait(readers, timeout=timeout)
        except (AttributeError, OSError, ValueError):
            time.sleep(min(0.02, timeout))

    # -- consumption -----------------------------------------------------
    def get(self, to_array, timeout: float):
        """Next batch in submission order (reorder buffer over the
        per-worker result queues).  Polls in `_POLL` slices so a dead
        worker is detected (and its batches resubmitted) immediately
        instead of after `timeout`."""
        from ...base import MXNetError
        self._skip_failed()
        want = self._next_yield
        t_start = time.monotonic()
        deadline = t_start + timeout
        while want not in self._reorder:
            if self._poll_queues():
                # timeout bounds the gap between ARRIVALS, not the total
                # wait for this batch id: a slow batch must not time out
                # while the other workers deliver steadily (the pipeline
                # is healthy)
                deadline = time.monotonic() + timeout
                continue
            respawned, _ = self._check_workers()
            if respawned:
                # recomputation gets a fresh budget
                deadline = time.monotonic() + timeout
                continue
            if time.monotonic() >= deadline:
                raise MXNetError(
                    f"DataLoader worker batch timed out after "
                    f"{timeout}s (num_workers={len(self._workers)}, "
                    f"all workers alive); a dataset transform is "
                    f"stuck or too slow — raise `timeout=` or debug "
                    f"the transform")
            # bounded by _POLL so dead-worker detection stays prompt,
            # but wakes immediately on any arrival
            self._wait_any(min(_POLL, timeout))
        tree = self._reorder.pop(want)
        self._next_yield += 1
        if _tele.enabled():
            _tele.histogram(
                "dataloader_batch_wait_ms",
                "Host wait for the next in-order DataLoader batch (ms)"
            ).observe((time.monotonic() - t_start) * 1e3)
        return _map_arrays(tree, to_array)

    def _discard(self, spec) -> None:
        """Unlink a raw spec's shared-memory segments without keeping it."""
        try:
            _from_shm(spec, lambda a: None)
        except Exception:
            pass

    def reset(self, timeout: float) -> None:
        """Drain every outstanding batch (discarding data + unlinking its
        segments) so a fresh epoch starts from a clean queue — an abandoned
        iterator (``for b in dl: break``) must not leak its prefetched
        batches into the next one."""
        deadline = time.monotonic() + timeout
        abandoned = set()
        while self._next_yield < self._next_submit:
            self._skip_failed()
            if self._next_yield in self._reorder:
                self._reorder.pop(self._next_yield)
                self._next_yield += 1
                continue
            if self._next_yield in abandoned:
                self._next_yield += 1   # died with its worker; not coming
                continue
            if self._poll_queues(raise_errors=False):
                deadline = time.monotonic() + timeout
                continue
            # dead workers are replaced for free here — their batches
            # are being discarded, so this is epoch-boundary
            # housekeeping, not failure recovery (no budget, no
            # resubmission)
            respawned, lost = self._check_workers(resubmit=False)
            if respawned:
                abandoned |= lost
                deadline = time.monotonic() + timeout
                continue
            if time.monotonic() >= deadline:
                break   # worker wedged; shutdown() will clean up
            self._wait_any(min(_POLL, timeout))
        # a worker that died IDLE (nothing in flight) never forces an
        # Empty poll above — sweep for corpses so the new epoch starts
        # with a full complement instead of assigning batches to one
        self._check_workers(resubmit=False)
        self._reorder.clear()
        self._pending.clear()
        self._owner.clear()
        self._failed.clear()
        for w in self._workers:
            w.assigned.clear()
        # batch ids stay monotonic across epochs: a wedged worker's stale
        # delivery then lands below _next_yield and is discarded instead
        # of colliding with a same-numbered batch of the new epoch
        self._next_yield = self._next_submit

    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        for w in self._workers:
            try:
                w.task_q.put(None)
            except Exception:
                pass
        for w in self._workers:
            w.proc.join(timeout=2)
            if w.proc.is_alive():
                w.proc.terminate()
                w.proc.join(timeout=1)
        # drain in-flight and buffered segments so nothing leaks /dev/shm
        self._reorder.clear()
        for w in self._workers:
            try:
                while True:
                    _bid, spec, _err = w.data_q.get_nowait()
                    if spec is not None:
                        self._discard(spec)
            except Exception:
                pass
        for w in self._workers:
            _cleanup_worker_shm(w.proc.pid)
