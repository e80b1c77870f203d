"""CheckpointManager — periodic checkpoint + auto-resume + verified restore
(counterpart of ``mxnet_tpu/utils/checkpoint.py``: the same names, file
names and manifest layout).

The reference has no recovery story (a dead ps-lite node kills the job).
Works with any target exposing ``save(path)`` / ``load(path)`` —
`parallel.TrainStep` is the canonical one — and implements the usual manager contract (atomic writes,
keep-last-K pruning, latest-step discovery) so a restarted job continues
from the newest complete checkpoint.

Integrity: every save writes a manifest sidecar
(``<ckpt>.npz.manifest.json``: size + sha256 + step + wall time), and
`restore()` verifies the newest checkpoint against it before loading. A
checkpoint that fails verification — or whose ``target.load`` raises — is
**quarantined** (renamed to ``*.corrupt``, manifest alongside) and restore
falls back through the chain of older checkpoints instead of raising on
the first, so a bit-rotted latest checkpoint costs one rollback, not the
job. Checkpoints predating the manifest format load with a warning (no
hash to check) but still fall back if the load itself fails.

Usage::

    mgr = CheckpointManager("/ckpts", keep=3)
    start = mgr.restore(step) or 0          # 0 when starting fresh
    for i in range(start, total_steps):
        loss = step(batch())
        mgr.maybe_save(step, i + 1, every=500)
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import tempfile
import time
from typing import List, Optional, Tuple

from .. import telemetry as _tele
from .. import tracing as _trace
from ..base import MXNetError
from ..resilience import fault_point, retry_with_backoff

__all__ = ["CheckpointManager"]

_log = logging.getLogger(__name__)

_FNAME = re.compile(r"^(?P<prefix>.+)-(?P<step>\d+)\.npz$")
_MANIFEST = ".manifest.json"


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, prefix: str = "ckpt"):
        if keep < 1:
            raise MXNetError("keep must be >= 1")
        self.directory = directory
        self.keep = keep
        self.prefix = prefix
        # final paths owned by an in-flight save_async: _prune must not
        # reap them mid-write (they get reaped by a later prune instead)
        self._pending_async: set = set()
        os.makedirs(directory, exist_ok=True)

    # -- data pipeline attachment ---------------------------------------
    def attach_pipeline(self, pipeline) -> None:
        """JAX couples a `data.DataPipeline` to the manager (its state
        rides every manifest and every restore seeks it).  The data
        pipeline is not ported: raises `MXNetError` naming the item."""
        raise MXNetError(
            "CheckpointManager.attach_pipeline: the data pipeline "
            "(gluon/data, mxnet_tpu/data) is not ported yet (ROADMAP.md "
            "A13)")

    def pipeline_state(self, path: str) -> Optional[dict]:
        """The ``data_pipeline`` state stored in `path`'s manifest, or
        None (external resume logic)."""
        return (self._manifest_meta(path) or {}).get("data_pipeline")

    # -- discovery -------------------------------------------------------
    def checkpoints(self) -> List[Tuple[int, str]]:
        """Sorted [(step, path)] of complete checkpoints on disk
        (quarantined ``*.corrupt`` files and manifests are excluded by the
        name pattern)."""
        out = []
        for fn in os.listdir(self.directory):
            m = _FNAME.match(fn)
            if m and m.group("prefix") == self.prefix:
                out.append((int(m.group("step")),
                            os.path.join(self.directory, fn)))
        return sorted(out)

    def latest(self) -> Optional[Tuple[int, str]]:
        cps = self.checkpoints()
        return cps[-1] if cps else None

    def _manifest_meta(self, path: str) -> Optional[dict]:
        try:
            with open(path + _MANIFEST) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _manifest_healthy(self, path: str) -> bool:
        """Whether the manifest's health tag permits a rollback to this
        checkpoint.  Untagged (legacy / health-off) checkpoints count as
        healthy — they predate the recovery subsystem, and excluding them
        would leave rollback with no candidates at all."""
        meta = self._manifest_meta(path)
        if not meta or "health" not in meta:
            return True
        return bool(meta["health"].get("healthy", True))

    def newest_healthy(self) -> Optional[Tuple[int, str]]:
        """Newest checkpoint whose manifest health tag says the run was
        healthy at save time — the rollback candidate."""
        for s, path in reversed(self.checkpoints()):
            if self._manifest_healthy(path):
                return (s, path)
        return None

    def discard_newer(self, step: int) -> List[int]:
        """Sideline every checkpoint NEWER than `step` (renamed to
        ``*.rolledback``, manifest alongside) so discovery skips them:
        after a rollback they belong to the abandoned diverged timeline,
        and a crash before the next periodic save must not resume into
        the state the rollback just rejected.  The rename keeps the
        evidence.
        Returns the discarded steps."""
        dropped = []
        for s, path in self.checkpoints():
            if s <= step:
                continue
            stale = path + ".rolledback"
            try:
                os.replace(path, stale)
            except OSError:
                continue
            man = path + _MANIFEST
            if os.path.exists(man):
                try:
                    os.replace(man, stale + _MANIFEST)
                except OSError:
                    pass
            dropped.append(s)
            if _tele.enabled():
                _tele.event("checkpoint_discard", step=s, path=path,
                            rolled_back_to=step)
        return dropped

    # -- integrity -------------------------------------------------------
    @staticmethod
    def _health_tag(step: int) -> Optional[dict]:
        """Health snapshot stamped into the manifest at save time (None
        when the health subsystem is off — legacy manifests stay
        byte-identical).  Rollback only considers checkpoints whose tag
        says ``healthy`` — restoring a checkpoint written mid-divergence
        would roll back INTO the anomaly."""
        try:
            from .. import recovery
            return recovery.health_snapshot(step)
        except Exception:
            return None

    def _write_manifest(self, path: str, step: int, target=None) -> None:
        """Manifest sidecar for `path` (atomic: tmp + rename). Written
        AFTER the checkpoint rename: a crash in between leaves a valid
        checkpoint that merely verifies as legacy/unmanifested."""
        meta = {"step": step, "size": os.path.getsize(path),
                "sha256": _sha256(path), "time": time.time(),
                "prefix": self.prefix}
        health = self._health_tag(step)
        if health is not None:
            meta["health"] = health
        # topology descriptor (mesh axis sizes at save time), when the
        # target has one: purely informational — checkpoints store
        # logical values, but the save-time layout lets restore announce
        # a cross-topology load
        topo = getattr(target, "topology", None)
        if callable(topo):
            try:
                meta["topology"] = topo()
            except Exception:
                pass
        fd, tmp = tempfile.mkstemp(dir=self.directory,
                                   prefix=f".{self.prefix}-man")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, path + _MANIFEST)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def _verify(self, path: str) -> Optional[str]:
        """None if `path` matches its manifest, else the failure reason.
        A missing manifest (pre-manifest checkpoint) verifies with a
        warning — there is nothing to check against."""
        man = path + _MANIFEST
        if not os.path.exists(man):
            _log.warning("checkpoint %s has no manifest (pre-manifest "
                         "format?); loading unverified", path)
            return None
        try:
            with open(man) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            return f"unreadable manifest: {e}"
        size = os.path.getsize(path)
        if size != meta.get("size"):
            return f"size mismatch (have {size}, manifest says " \
                   f"{meta.get('size')})"
        digest = _sha256(path)
        if digest != meta.get("sha256"):
            return "sha256 mismatch (checkpoint bytes changed on disk)"
        return None

    def _quarantine(self, path: str, reason: str) -> str:
        """Rename a bad checkpoint (+ manifest) to ``*.corrupt`` so
        discovery skips it but the evidence survives for forensics."""
        corrupt = path + ".corrupt"
        if _tele.enabled():
            _tele.counter(
                "checkpoint_quarantines",
                "Checkpoints renamed *.corrupt after failing "
                "verification or load").inc()
            _tele.event("checkpoint_quarantine", path=path, reason=reason)
        _log.error("checkpoint %s failed verification/load (%s); "
                   "quarantining as %s", path, reason, corrupt)
        try:
            os.replace(path, corrupt)
        except OSError:
            pass
        man = path + _MANIFEST
        if os.path.exists(man):
            try:
                os.replace(man, corrupt + _MANIFEST)
            except OSError:
                pass
        return corrupt

    # -- save/restore ----------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}-{step}.npz")

    def save(self, target, step: int) -> str:
        """Checkpoint `target` at `step`. The write is atomic (temp file +
        rename) so a crash mid-save never leaves a truncated checkpoint as
        the latest; the manifest sidecar follows the rename."""
        self.wait_async()
        final = self._path(step)
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(dir=self.directory,
                                   prefix=f".{self.prefix}-tmp")
        os.close(fd)
        try:
            fault_point("ckpt_write")
            target.save(tmp)
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._write_manifest(final, step, target)
        self._prune()
        self._note_write(final, step, time.perf_counter() - t0)
        return final

    @staticmethod
    def _note_write(path: str, step: int, elapsed_s: float,
                    async_save: bool = False) -> None:
        if _trace.enabled():
            t1 = time.perf_counter()
            _trace.get_tracer("checkpoint").record_span(
                "checkpoint.save", t1 - elapsed_s, t1,
                track="checkpoint", step=step, async_save=async_save,
                path=os.path.basename(path))
        if _tele.enabled():
            ms = elapsed_s * 1e3
            _tele.histogram(
                "checkpoint_write_ms",
                "Checkpoint write duration incl. manifest (ms)"
            ).observe(ms)
            _tele.event("checkpoint_write", step=step, path=path,
                        ms=round(ms, 3), async_save=async_save)

    _last_async = None

    def save_async(self, target, step: int):
        """Non-stalling checkpoint for targets that support it
        (`TrainStep.save_async`): snapshot now, write + prune in
        the background. Returns a future resolving to the final path;
        targets without `save_async` fall back to a blocking `save` (the
        returned future is already resolved). The manager tracks the
        newest future, so even a dropped one surfaces its error at the
        next save/restore/`wait_async` instead of vanishing."""
        import concurrent.futures as _fut
        self.wait_async()
        if not hasattr(target, "save_async"):
            done: _fut.Future = _fut.Future()
            done.set_result(self.save(target, step))
            return done
        final = self._path(step)
        # manager-side tmp + rename: the restore path treats the NEWEST
        # file as a complete checkpoint, so a generic target whose
        # save_async writes in place must never leave a truncated file
        # at the final name (TrainStep is atomic on its own; the extra
        # same-directory rename is free)
        fault_point("ckpt_write")
        fd, tmp = tempfile.mkstemp(dir=self.directory,
                                   prefix=f".{self.prefix}-atmp")
        os.close(fd)
        t0 = time.perf_counter()
        self._pending_async.add(final)
        inner = target.save_async(tmp)

        out: _fut.Future = _fut.Future()

        def _finish(f):
            try:
                f.result()
                os.replace(tmp, final)
                self._write_manifest(final, step, target)
                self._pending_async.discard(final)
                self._prune()
                self._note_write(final, step, time.perf_counter() - t0,
                                 async_save=True)
                out.set_result(final)
            except BaseException as e:  # surface writer errors to .result()
                self._pending_async.discard(final)
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                out.set_exception(e)

        inner.add_done_callback(_finish)
        self._last_async = out
        return out

    def wait_async(self) -> None:
        """Block until the newest async save finishes; re-raise its error
        (clearing it first, so one failure can't wedge every later save)."""
        fut, self._last_async = self._last_async, None
        if fut is not None:
            fut.result()

    def maybe_save(self, target, step: int, every: int,
                   async_save: bool = False) -> Optional[str]:
        if every > 0 and step % every == 0:
            if async_save:
                self.save_async(target, step)
                return self._path(step)
            return self.save(target, step)
        return None

    def restore(self, target, step: Optional[int] = None,
                healthy_only: bool = False) -> int:
        """Load the newest VERIFIED checkpoint into `target` and return
        its step (0 when the directory has none).

        With explicit `step`: verify + load exactly that checkpoint,
        raising on corruption (the caller asked for that one — falling
        back silently would be surprising).

        Default (latest): walk the chain newest → oldest; a checkpoint
        that fails verification or whose ``target.load`` raises is
        quarantined and the next-older one is tried. Raises `MXNetError`
        only when checkpoints exist but every one is corrupt. Note a
        failed ``load`` may leave `target` partially mutated; the
        fallback load overwrites the full state, so the target is
        consistent whenever restore returns.

        `healthy_only` (the recovery rollback path): checkpoints whose
        manifest health tag says they were written in an anomalous window
        are SKIPPED (not quarantined — the bytes are fine, the state is
        suspect).  Should every healthy candidate fail, the skipped
        unhealthy ones are tried after all — a suspect restore beats no
        restore."""
        self.wait_async()
        t0 = time.perf_counter()
        if step is not None:
            path = self._path(step)
            if not os.path.exists(path):
                raise MXNetError(f"no checkpoint for step {step} in "
                                 f"{self.directory}")
            reason = self._verify(path)
            if reason is not None:
                raise MXNetError(f"checkpoint {path} failed verification: "
                                 f"{reason}")
            fault_point("ckpt_read")
            target.load(path)
            self._note_topology_change(path, target)
            self._note_restore(path, step, time.perf_counter() - t0)
            return step
        chain = self.checkpoints()
        if not chain:
            return 0
        failures: List[str] = []
        if healthy_only:
            healthy = [c for c in chain if self._manifest_healthy(c[1])]
            if len(healthy) < len(chain):
                _log.warning(
                    "restore: skipping %d checkpoint(s) tagged unhealthy; "
                    "%d rollback candidate(s) remain",
                    len(chain) - len(healthy), len(healthy))
            got = self._restore_chain(target, healthy, t0, failures)
            if got is not None:
                return got
            rest = [c for c in chain if c not in healthy
                    and os.path.exists(c[1])]
            if rest:
                _log.error(
                    "restore: every healthy-tagged checkpoint failed; "
                    "falling back to %d unhealthy-tagged one(s)", len(rest))
                got = self._restore_chain(target, rest, t0, failures)
                if got is not None:
                    return got
        else:
            got = self._restore_chain(target, chain, t0, failures)
            if got is not None:
                return got
        raise MXNetError(
            f"all {len(failures)} checkpoint(s) in {self.directory} "
            f"failed to restore (quarantined: {failures}); refusing to "
            f"silently restart from scratch. If the files verified but "
            f"failed to LOAD, the target is likely incompatible (changed "
            f"architecture?) — quarantine is a rename; strip the "
            f"'.corrupt' suffix to recover the files")

    def _restore_chain(self, target, chain: List[Tuple[int, str]],
                       t0: float, failures: List[str]) -> Optional[int]:
        """Walk `chain` newest → oldest quarantining failures; the step
        restored, or None when every entry failed."""
        for s, path in reversed(chain):
            reason = self._verify(path)
            if reason is None:
                try:
                    # transient I/O blips (flaky NFS) are retried before a
                    # sha256-verified checkpoint is condemned — quarantine
                    # is for corruption, not weather
                    def _load():
                        fault_point("ckpt_read")
                        target.load(path)
                    retry_with_backoff(_load, retries=2, base_delay=0.1,
                                       retry_on=(OSError,))
                except Exception as e:  # noqa: BLE001 — any load error
                    # the bytes passed verification — if this repeats down
                    # the whole chain it is a target/format incompatibility
                    # (changed architecture?), not corruption; quarantine
                    # is a rename, reversible by stripping the suffix
                    reason = (f"load failed on a verification-passing "
                              f"checkpoint ({type(e).__name__}: {e})")
                else:
                    if failures:
                        _log.warning(
                            "restore: fell back to checkpoint at step %d "
                            "after quarantining %d newer corrupt "
                            "checkpoint(s)", s, len(failures))
                    self._note_topology_change(path, target)
                    self._note_restore(path, s, time.perf_counter() - t0,
                                       fallbacks=len(failures))
                    return s
            failures.append(self._quarantine(path, reason))
        return None

    def _note_topology_change(self, path: str, target) -> None:
        """Announce a topology-agnostic restore: the checkpoint's
        manifest recorded a different mesh than the target runs now —
        worth a log line + journal event."""
        topo = getattr(target, "topology", None)
        if not callable(topo):
            return
        saved = (self._manifest_meta(path) or {}).get("topology")
        if not saved:
            return
        try:
            now = topo()
        except Exception:
            return
        if saved.get("axes") != now.get("axes"):
            _log.warning(
                "checkpoint %s was written under mesh %s; restored "
                "topology-agnostically onto %s", path,
                saved.get("axes"), now.get("axes"))
            if _tele.enabled():
                _tele.event("checkpoint_cross_topology", path=path,
                            saved_axes=saved.get("axes"),
                            restored_axes=now.get("axes"))

    @staticmethod
    def _note_restore(path: str, step: int, elapsed_s: float,
                      fallbacks: int = 0) -> None:
        if _trace.enabled():
            t1 = time.perf_counter()
            _trace.get_tracer("checkpoint").record_span(
                "checkpoint.restore", t1 - elapsed_s, t1,
                track="checkpoint", step=step, fallbacks=fallbacks,
                path=os.path.basename(path))
        if _tele.enabled():
            ms = elapsed_s * 1e3
            _tele.histogram(
                "checkpoint_restore_ms",
                "Checkpoint verify+load duration (ms)").observe(ms)
            _tele.event("checkpoint_restore", step=step, path=path,
                        ms=round(ms, 3), fallbacks=fallbacks)

    def _prune(self):
        cps = self.checkpoints()
        for _, path in cps[:-self.keep]:
            if path in self._pending_async:
                # a background save_async still owns this path (possible
                # after a rollback reordered the step sequence): deleting
                # under the writer would truncate it — leave it for the
                # next prune, after the future settles
                continue
            try:
                os.unlink(path)
            except OSError:
                pass
            try:
                os.unlink(path + _MANIFEST)
            except OSError:
                pass
