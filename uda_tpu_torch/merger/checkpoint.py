"""Crash-consistent checkpoint/resume of a half-merged reduce task.

The port's copy of ``uda_tpu/merger/checkpoint.py``; the files it writes
are the reference's, byte for byte, so either package resumes the other's
checkpoint. A reducer death used to lose every fetched, spooled and
half-merged byte. This module makes the reduce task's durable state an
atomic, versioned *manifest* under ``uda.tpu.ckpt.dir``:

- the **sorted run files** are already durable: the RunStore writes them
  to disk as segments spool; the manifest records each run's record
  count, byte length and CRC so a torn spool is detected and fetched
  again rather than merged;
- the **fetch offset ledgers** of in-flight segments (framed batches +
  carry + next offset, from ``Segment.ckpt_export``) are side ``part``
  files, so a restart continues each fetch mid-partition;
- the **RecoveryLedger journal** and **penalty-box** state ride along;
- the **merge-forest watermark** (the OverlappedMerger stats) is recorded
  for diagnostics; the forest itself is device state and is rebuilt from
  the adopted runs on resume.

Manifest format (``manifest-<seq>.uckp``)::

    UCKP1 <crc32-of-payload> <payload-byte-length>\\n
    <payload: one JSON object>

Atomicity is write-to-temp + fsync + rename; the previous manifest is kept
until the new one lands (and ``uda.tpu.ckpt.keep`` older ones after that),
so a kill mid-snapshot, or an injected ``ckpt.save`` truncate, always
leaves a valid manifest to fall back to. A manifest is consumed on load
(an atomic rename claims it), so a zombie attempt can never resume state
a successor claimed; a manifest written by a higher tenant epoch is
refused.

The revalidation ladder on resume: supplier generation against the
recorded one (a cold supplier restart drops that source's ledger and
keeps its run files) -> epoch fence -> per-file length + CRC -> drop and
fetch again on any mismatch. Saving is best effort: a failed snapshot
degrades the resume point and never fails the task.

Every save, load and discard is a flight-recorder event.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from typing import Callable, Optional

import numpy as np

from uda_tpu_torch.utils.errors import StorageError
from uda_tpu_torch.utils.failpoints import failpoint
from uda_tpu_torch.utils.flightrec import flightrec
from uda_tpu_torch.utils.ifile import EOF_MARKER, crack_partial
from uda_tpu_torch.utils.locks import TrackedLock
from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import metrics

__all__ = ["TaskCheckpoint", "read_run"]

log = get_logger()

_MAGIC = b"UCKP1"
_MANIFEST_FMT = "manifest-%08d.uckp"


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync (the rename itself is what must be
    durable; some filesystems need the parent flushed too)."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def _write_atomic(path: str, data: bytes) -> None:
    """temp + fsync + rename: the file either exists complete or not at
    all (a torn write lives only under the .tmp name, never the real
    one)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


def read_run(run_path: str, off_path: str, rec: dict):
    """Validate one checkpointed run file against its manifest record
    (length + CRC over the whole file including the EOF marker, offset
    sidecar shape) and re-crack it. Returns the RecordBatch; raises
    :class:`StorageError` on any mismatch — the caller then drops the
    file and re-fetches the segment from its source."""
    with open(run_path, "rb") as f:
        data = f.read()
    if len(data) != int(rec["length"]):
        raise StorageError(
            f"checkpointed run {run_path} is {len(data)} bytes, "
            f"manifest records {rec['length']} (torn spool)")
    if zlib.crc32(data) & 0xFFFFFFFF != int(rec["crc"]):
        raise StorageError(
            f"checkpointed run {run_path} failed its CRC check")
    records = int(rec["records"])
    nbytes = int(rec["bytes"])
    ends = np.fromfile(off_path, dtype="<i8")
    if ends.shape[0] != records or (records and int(ends[-1]) != nbytes):
        raise StorageError(
            f"checkpointed run {run_path}: offset sidecar shape "
            f"{ends.shape[0]}/{int(ends[-1]) if len(ends) else 0} does "
            f"not match the manifest ({records}/{nbytes})")
    batch, _, _ = crack_partial(data, expect_eof=True)
    if batch.num_records != records:
        raise StorageError(
            f"checkpointed run {run_path} re-cracked to "
            f"{batch.num_records} records, manifest says {records}")
    return batch


class TaskCheckpoint:
    """The durable snapshot store of ONE reduce task attempt.

    Layout under ``<root>/<job>.r<reduce>/``::

        manifest-<seq>.uckp   versioned manifests (newest wins on load)
        runs/                 the RunStore's fixed directory (run files
                              + offset sidecars survive the process)
        parts/                per-save in-flight fetch-ledger bytes
                              (p<seq>-s<seg>.part, named by save seq so
                              retained older manifests stay loadable)

    ``version`` is a monotone save-phase counter fed into the stall
    watchdog's progress token: a long fsync IS progress, never a stall.
    ``maybe_save`` is the run-spool-boundary trigger — rate-limited by
    ``interval_s`` (0 = every boundary), non-blocking across concurrent
    stage workers, and total: any save failure is counted
    (``ckpt.save.errors``) and logged, never raised into the task.
    """

    def __init__(self, root_dir: str, job_id: str, reduce_id: int, *,
                 interval_s: float = 30.0, keep: int = 2, epoch: int = 1):
        self.job_id = job_id
        self.reduce_id = int(reduce_id)
        self.interval_s = max(0.0, float(interval_s))
        self.keep = max(1, int(keep))
        self.epoch = int(epoch)
        self.task = f"{job_id}.r{reduce_id}"
        self.task_dir = os.path.join(root_dir, self.task)
        self.runs_dir = os.path.join(self.task_dir, "runs")
        self.parts_dir = os.path.join(self.task_dir, "parts")
        for d in (self.task_dir, self.runs_dir, self.parts_dir):
            os.makedirs(d, exist_ok=True)
        self.version = 0          # monotone save-phase counter (watchdog)
        self._seq = 0             # last written manifest sequence number
        self._last_save = 0.0     # monotonic time of the last save
        self._save_lock = TrackedLock("ckpt.save")

    # -- save side ----------------------------------------------------------

    def maybe_save(self, collect: Callable[[], tuple], *,
                   force: bool = False) -> bool:
        """The spool-boundary trigger: save when ``interval_s`` has
        elapsed since the last snapshot (``force`` bypasses the
        interval). Concurrent callers skip instead of queueing (one
        consistent snapshot per boundary is enough), and EVERY failure
        is absorbed here — checkpointing must never fail the task it
        protects."""
        if not force and self.interval_s > 0 and \
                time.monotonic() - self._last_save < self.interval_s:
            return False
        if not self._save_lock.acquire(blocking=False):
            return False  # a concurrent stage worker is already saving
        try:
            self._save_locked(collect)
            return True
        except Exception as e:  # noqa: BLE001 - best-effort by contract:
            # a failed snapshot only degrades the resume point
            metrics.add("ckpt.save.errors")
            log.warn(f"checkpoint save of {self.task} failed "
                     f"(task continues, resume point unchanged): {e}")
            return False
        finally:
            self._save_lock.release()

    def save(self, collect: Callable[[], tuple]) -> None:
        """One forced snapshot; raises on failure (tests / the explicit
        post-adoption snapshot go through :meth:`maybe_save` with
        ``force=True`` in production paths)."""
        with self._save_lock:
            self._save_locked(collect)

    def _save_locked(self, collect: Callable[[], tuple]) -> None:
        t0 = time.perf_counter()
        seq = self._seq + 1
        payload, parts = collect()
        total_bytes = 0
        # part files first: the manifest must only ever reference parts
        # that are already durable (named by seq, so retained OLDER
        # manifests keep referencing their own seq's parts)
        for i, data in parts.items():
            entry = payload["ledgers"].get(str(i))
            if entry is None:
                continue
            name = f"p{seq:08d}-s{int(i):05d}.part"
            _write_atomic(os.path.join(self.parts_dir, name), data)
            entry["part"] = name
            entry["part_len"] = len(data)
            entry["part_crc"] = zlib.crc32(data) & 0xFFFFFFFF
            total_bytes += len(data)
            self.version += 1  # each durable phase is watchdog progress
        payload["seq"] = seq
        payload["epoch"] = self.epoch
        body = json.dumps(payload, sort_keys=True).encode("utf-8")
        file_bytes = (b"%s %d %d\n" % (_MAGIC, zlib.crc32(body) & 0xFFFFFFFF,
                                       len(body))) + body
        # the injectable boundary: truncate = a torn manifest on disk
        # (load must fall back to the previous one), error = a failed
        # snapshot (absorbed by maybe_save), delay = a slow fsync (the
        # watchdog-token test rides it)
        file_bytes = failpoint("ckpt.save", data=file_bytes, key=self.task)
        path = os.path.join(self.task_dir, _MANIFEST_FMT % seq)
        _write_atomic(path, bytes(file_bytes))
        _fsync_dir(self.task_dir)
        self._seq = seq
        self._last_save = time.monotonic()
        self.version += 1
        total_bytes += len(file_bytes)
        self._prune()
        save_ms = (time.perf_counter() - t0) * 1e3
        metrics.add("ckpt.snapshots")
        metrics.add("ckpt.bytes", total_bytes)
        metrics.observe("ckpt.save_ms", save_ms)
        flightrec.record("ckpt.save", seq=seq,
                         runs=len(payload.get("runs") or {}),
                         ledgers=len(payload.get("ledgers") or {}),
                         bytes=total_bytes)

    def _manifests(self) -> list[tuple[int, str]]:
        """(seq, path) of every live manifest, newest first."""
        out = []
        try:
            names = os.listdir(self.task_dir)
        except OSError:
            return []
        for name in names:
            if not name.startswith("manifest-") or \
                    not name.endswith(".uckp"):
                continue
            try:
                seq = int(name[len("manifest-"):-len(".uckp")])
            except ValueError:
                continue
            out.append((seq, os.path.join(self.task_dir, name)))
        out.sort(reverse=True)
        return out

    def _prune(self) -> None:
        """Drop manifests beyond ``keep`` and part files older than the
        oldest retained manifest's save (parts are referenced only by
        the manifest of their own seq, by construction)."""
        manifests = self._manifests()
        keep_seqs = {s for s, _ in manifests[:self.keep]}
        for seq, path in manifests[self.keep:]:
            try:
                os.unlink(path)
            except OSError:
                pass
        floor = min(keep_seqs) if keep_seqs else 0
        try:
            part_names = os.listdir(self.parts_dir)
        except OSError:
            return
        for name in part_names:
            if not (name.startswith("p") and name.endswith(".part")):
                continue
            try:
                seq = int(name[1:9])
            except ValueError:
                continue
            if seq < floor:
                try:
                    os.unlink(os.path.join(self.parts_dir, name))
                except OSError:
                    pass

    # -- load side ----------------------------------------------------------

    def load(self) -> Optional[dict]:
        """Find, validate and CONSUME the newest manifest of this task.

        Walks manifests newest-first: a torn one (bad magic, length or
        CRC — e.g. a kill mid-snapshot or an injected ``ckpt.save``
        truncate) is unlinked and the walk falls back to the previous
        manifest — never a broken one, never a crash. A manifest
        written by a HIGHER tenant epoch means THIS process is the
        zombie: it must not consume its successor's state. The winner
        is claimed by atomic rename (consumed-on-load), so two racing
        attempts can never both resume it. Returns the payload dict or
        None (fresh start)."""
        try:
            failpoint("ckpt.load", key=self.task)
        except StorageError as e:
            # an unreadable checkpoint store degrades to a fresh start,
            # never a crash (the whole point of best-effort durability)
            metrics.add("ckpt.invalidated", cause="load")
            log.warn(f"checkpoint load of {self.task} failed; starting "
                     f"fresh: {e}")
            return None
        for seq, path in self._manifests():
            payload = self._read_manifest(path)
            if payload is None:
                metrics.add("ckpt.invalidated", cause="torn")
                log.warn(f"checkpoint manifest {path} is torn; falling "
                         f"back to the previous one")
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            if int(payload.get("epoch", 0)) > self.epoch:
                # epoch fence: the manifest belongs to a NEWER
                # attempt — this process is the zombie; leave the state
                # for its rightful owner
                metrics.add("ckpt.invalidated", cause="epoch")
                log.warn(f"checkpoint manifest {path} was written by "
                         f"epoch {payload.get('epoch')} > ours "
                         f"{self.epoch}; refusing to resume it")
                return None
            try:
                os.rename(path, path + ".consumed")
            except OSError:
                return None  # a racing attempt claimed it first
            try:
                os.unlink(path + ".consumed")
            except OSError:
                pass
            self._seq = max(self._seq, seq)
            flightrec.record("ckpt.load", seq=seq,
                             runs=len(payload.get("runs") or {}),
                             ledgers=len(payload.get("ledgers") or {}))
            return payload
        return None

    @staticmethod
    def _read_manifest(path: str) -> Optional[dict]:
        """Parse + integrity-check one manifest; None when torn."""
        try:
            with open(path, "rb") as f:
                raw = f.read()
            head, _, body = raw.partition(b"\n")
            fields = head.split(b" ")
            if len(fields) != 3 or fields[0] != _MAGIC:
                return None
            crc, length = int(fields[1]), int(fields[2])
            if len(body) != length or \
                    zlib.crc32(body) & 0xFFFFFFFF != crc:
                return None
            payload = json.loads(body.decode("utf-8"))
            return payload if isinstance(payload, dict) else None
        except (OSError, ValueError, UnicodeDecodeError):
            return None

    def part_bytes(self, entry: dict) -> bytes:
        """Read + integrity-check one ledger part file; raises
        :class:`StorageError` on any mismatch (the caller drops the
        ledger and re-fetches that segment from zero)."""
        name = str(entry.get("part") or "")
        if not name or os.sep in name or name.startswith("."):
            raise StorageError(f"checkpoint ledger names no valid part "
                               f"file ({name!r})")
        path = os.path.join(self.parts_dir, name)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            raise StorageError(f"checkpoint part {name} unreadable: "
                               f"{e}") from e
        if len(data) != int(entry.get("part_len", -1)) or \
                zlib.crc32(data) & 0xFFFFFFFF != int(entry.get("part_crc",
                                                               -1)):
            raise StorageError(
                f"checkpoint part {name} failed its length/CRC check")
        return data

    # -- lifecycle ----------------------------------------------------------

    def discard(self) -> None:
        """Remove the whole task checkpoint (the task completed: its
        emitted output is the durable artifact now)."""
        shutil.rmtree(self.task_dir, ignore_errors=True)
        flightrec.record("ckpt.discard", task=self.task)


# the manifest's run "length" convention: framed record bytes + the
# IFile EOF marker, i.e. the complete on-disk run file size
RUN_EOF_LEN = len(EOF_MARKER)
