"""Process-parallel host loader: a shared-memory ring of batch slabs.

Counterpart of ``deepfake_detection_tpu/data/shm_ring.py`` (its names and
its protocol; ``--loader-backend shm``).  The thread backend
(:class:`~.loader.HostLoader`) runs the host chain on threads of the
trainer's own process, where the Python glue between its native stages
holds the interpreter lock against the thread that dispatches the train
step.  Here N *spawned* worker processes (no shared interpreter lock, no
fork-inherited threads or CUDA context) decode and transform samples and
write their uint8 NHWC bytes straight into a preallocated
``multiprocessing.shared_memory`` ring of batch slabs at the sample's slot:
no image byte is pickled, and a batch is complete when its last worker
acks.

Determinism: a sample is a pure function of ``(seed, epoch, index)``: the
workers draw from the generator the thread backend uses, so both backends
give bitwise the same batches for any worker count.  That purity also makes
crash recovery idempotent: a lost task run again writes the same bytes.

Robustness, as the JAX module:

* **Backpressure**: at most ``ring_depth`` batches are in flight, and a
  slab is dispatched again only once its batch has been copied out.
* **Worker crashes**: a worker publishes its current ``(batch, slot)``
  task in a shared cell before touching the sample and clears it after its
  ack; the collector polls ``exitcode``, respawns a dead worker and
  re-dispatches the one task it can have lost.  Acks travel on one pipe a
  worker, sent by the worker's own thread, where the JAX module shares one
  queue: a worker killed while that queue's feeder thread held the queue's
  write lock blocked every other worker's acks for good (the collector
  then swept forever; seen under load on the CPU, and the likely cause of
  the JAX crash test's hangs).
* **Stalls**: workers heartbeat a shared timestamp a task; one silent past
  ``heartbeat_timeout`` while holding a task is terminated and handled as
  a crash (a task that stalled once is let run the second time).
* **Shutdown**: ``close()`` (also a ``weakref.finalize``) stops the
  workers, drains the queues and unlinks the segment; an abandoned
  iteration is quiesced by a generation counter, so no stale task writes
  into a recycled slab (each worker checks the slot's owner token right
  before it writes).

What differs from JAX: the consumer yields the port's
:class:`~.loader.HostBatch`, with :class:`~.loader.HostLoader`'s interface
(``prepare``, ``stats``, ``start_batch``, ``set_epoch``, ``close``), so
the ``DeviceLoader``, the trainer, resilience and telemetry take either
backend without a branch.  A collector thread of the trainer's process
waits for each batch, copies it out of its slab into a buffer of its own
(pinned when the device is a card: the thread backend collates into the
same kind of buffer), frees the slab for the next dispatch, and runs the
collate mixup and ``prepare`` there (keyed ``[seed, epoch, batch, tag]``,
as the thread backend draws them), off the dispatching thread.  A yielded
batch therefore owns its memory: no slab is read by a copy to the card,
and the mixup blend writes only into the batch's own buffer.  The copy out
of the slab is ``copy_s``.

Workers import no torch: a spawned worker imports this module, the chaos
module and what its dataset pickles by module path (``data/dataset.py``,
``transforms.py``, ``imaging.py``, ``native.py``, ``packed.py``,
``auto_augment.py``, ``resample.py``, ``samplers.py``), all torch-free;
the consumer half imports torch inside its methods.  A spawned child would
otherwise run the parent's ``__main__`` module again before unpickling its
task (a trainer's or a script's imports torch), so the parent's main
module is hidden from the spawn.  The native library is built or loaded in
the parent by the probe decode, before the first spawn, wherever the
dataset uses it; each worker's native pool gets ``cpu_count // workers``
threads, 1 to 4.  JPEG frames that the decoder declines are counted in the
worker and the count rides back in the ack into the parent's
``data.dataset.decode_fallbacks``.
"""

from __future__ import annotations

import contextlib
import errno
import logging
import multiprocessing as mp
import os
import queue as queue_mod
import sys
import threading
import time
import weakref
from multiprocessing import connection as mp_connection
from multiprocessing import shared_memory
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from . import dataset as _dataset_mod
from . import native as _native
from ..chaos import CHAOS_ENV_VAR, chaos_from_env
from .samplers import epoch_batches

_logger = logging.getLogger(__name__)

__all__ = ["ShmRing", "ShmRingLoader", "SHM_DIR", "shm_free_bytes"]

#: where POSIX shared memory lives on Linux (``shm_open``)
SHM_DIR = "/dev/shm"


def shm_free_bytes(path: str = SHM_DIR) -> int:
    """Bytes free for an unprivileged writer under ``path``."""
    st = os.statvfs(path)
    return int(st.f_bavail) * int(st.f_frsize)


def _attach_untracked(name: str) -> shared_memory.SharedMemory:
    """Attach to an existing segment WITHOUT registering it with the
    resource tracker: attachers registering the creator's segment make the
    (process-tree-shared) tracker unlink it when any worker exits
    (bpo-38119), yanking the ring out from under the survivors.  Python
    3.13 grew ``track=False`` for this; on older interpreters (the card's
    machine has 3.12) the registration hook is swapped out for the attach
    (single-threaded worker startup, so the swap cannot race)."""
    try:
        return shared_memory.SharedMemory(name=name, track=False)
    except TypeError:  # pre-3.13: no track kwarg
        pass
    from multiprocessing import resource_tracker
    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig


class ShmRing:
    """``depth`` batch slabs in one shared-memory segment.

    Layout: ``(depth, rows, H, W, C)`` uint8 image slabs followed (64-byte
    aligned) by ``(depth, batch)`` int64 target slabs.  ``rows`` is
    ``batch * num_splits``: AugMix multi-view samples land split-major,
    the layout the thread backend's collate produces.
    """

    def __init__(self, depth: int, rows: int, img_shape: Sequence[int],
                 batch: int, name: Optional[str] = None,
                 create: bool = False):
        self.depth = int(depth)
        self.rows = int(rows)
        self.img_shape = tuple(int(d) for d in img_shape)
        self.batch = int(batch)
        self._tgt_off, total = self.layout(self.depth, self.rows,
                                           self.img_shape, self.batch)
        if create:
            self.shm = shared_memory.SharedMemory(create=True, size=total)
        else:
            self.shm = _attach_untracked(name)
        self.images = np.ndarray((self.depth, self.rows) + self.img_shape,
                                 np.uint8, buffer=self.shm.buf)
        self.targets = np.ndarray((self.depth, self.batch), np.int64,
                                  buffer=self.shm.buf, offset=self._tgt_off)

    @staticmethod
    def layout(depth: int, rows: int, img_shape: Sequence[int],
               batch: int) -> Tuple[int, int]:
        """``(target offset, segment bytes)`` of a ring."""
        img_bytes = int(depth) * int(rows) * int(np.prod(img_shape))
        tgt_off = -(-img_bytes // 64) * 64
        return tgt_off, tgt_off + int(depth) * int(batch) * 8

    @property
    def name(self) -> str:
        return self.shm.name

    def close(self, unlink: bool = False) -> None:
        self.images = None
        self.targets = None
        try:
            self.shm.close()
        except BufferError:
            # a view of a slab is still alive; the mapping goes with the
            # last view or the process; unlink below still removes the name
            pass
        if unlink:
            try:
                self.shm.unlink()
            except FileNotFoundError:
                pass


# ---------------------------------------------------------------------------
# Worker process (torch-free)
# ---------------------------------------------------------------------------

def _owner_token(gen: int, bi: int) -> int:
    """One int64 identifying which (iteration, batch) owns a ring slot."""
    return (int(gen) << 32) | (int(bi) & 0xFFFFFFFF)


def _worker_main(wid: int, dataset: Any, seed: int, shm_name: str,
                 depth: int, rows: int, img_shape: Tuple[int, ...],
                 batch: int, task_q, ack, stop_ev, hb, cur, gen, owner,
                 native_threads: int) -> None:
    """One decode worker: pull ``(slot, j, index, epoch, bi, gen)`` sample
    tasks, write the transformed uint8 sample at its slot offset, ack
    ``(gen, bi, j, error, decode fallbacks)`` on its own pipe ``ack``
    (sent from this thread before the next task is taken).  Errors are
    reported a sample, not fatal: the consumer decides.  Protocol order
    matters for crash recovery: the current-task cell is set BEFORE any
    work and cleared only AFTER the ack, so the consumer can always tell
    what a dead worker may have lost.  Before touching a slab the worker
    checks that it still OWNS the slot (``owner[slot]`` holds the (gen, bi)
    token the consumer wrote at dispatch): a stale task, from an abandoned
    iteration or a duplicate of a lost-ack re-dispatch run after its batch
    was taken, must never write into a recycled slab."""
    _native.set_default_pool_threads(native_threads)
    chaos = None
    if wid == 0 and os.environ.get(CHAOS_ENV_VAR):
        # fault injection, worker 0 only: die after the Nth completed task
        # so the consumer's respawn and re-dispatch meet a REAL dead process
        chaos = chaos_from_env()
        if "kill_shm_worker" not in chaos.points:
            chaos = None
    tasks_done = 0
    ring = ShmRing(depth, rows, img_shape, batch, name=shm_name)
    base = 3 * wid
    last_epoch: Optional[int] = None
    try:
        while True:
            try:
                task = task_q.get(timeout=0.5)
            except queue_mod.Empty:
                hb[wid] = time.monotonic()
                if stop_ev.is_set():
                    break
                continue
            if task is None:
                break
            if chaos is not None and chaos.fires("kill_shm_worker",
                                                 tasks_done):
                os._exit(113)       # hard death: no ack, no cleanup
            tasks_done += 1
            slot, j, index, epoch, bi, task_gen = task
            cur[base + 1] = bi
            cur[base + 2] = j
            cur[base] = 1
            hb[wid] = time.monotonic()
            token = _owner_token(task_gen, bi)
            if task_gen != gen.value or owner[slot] != token:
                cur[base] = 0
                continue
            err = None
            fallbacks = _dataset_mod.decode_fallbacks
            try:
                if epoch != last_epoch:
                    if hasattr(dataset, "set_epoch"):
                        dataset.set_epoch(epoch)
                    last_epoch = epoch
                rng = np.random.default_rng(
                    np.random.SeedSequence([seed, epoch, int(index)]))
                img, target = dataset.__getitem__(int(index), rng=rng)
                arr = np.asarray(img, dtype=np.uint8)
                if owner[slot] == token:
                    # the authoritative pre-write check: the slot may have
                    # been recycled while this stale or duplicate task ran
                    if arr.ndim == 4:    # (S, H, W, C) AugMix views →
                        for s in range(arr.shape[0]):   # split-major rows
                            ring.images[slot, s * batch + j] = arr[s]
                    else:
                        ring.images[slot, j] = arr
                    ring.targets[slot, j] = int(target)
            except Exception as e:
                # reported a sample.  An interrupt (Ctrl-C reaches the
                # process group) is not an Exception: it kills the worker
                # and the crash path applies, so it cannot beat the
                # consumer's own KeyboardInterrupt as a sample error
                err = f"{type(e).__name__}: {e}"
            ack.send((task_gen, bi, j, err,
                      _dataset_mod.decode_fallbacks - fallbacks))
            cur[base] = 0
    finally:
        ring.close()
        ack.close()


# ---------------------------------------------------------------------------
# Consumer
# ---------------------------------------------------------------------------

class _Stopped(Exception):
    """The iteration was abandoned or the loader closed: the collector
    thread leaves."""


@contextlib.contextmanager
def _main_hidden():
    """Start a spawned child without the parent's ``__main__``: spawn runs
    the parent's main module again in the child (as ``__mp_main__``)
    before unpickling the task, and a trainer's or a script's main module
    imports torch and the model stack.  The worker's task and dataset are
    pickled by module path and need none of it."""
    main = sys.modules.get("__main__")
    if main is None:
        yield
        return
    saved = {k: main.__dict__[k] for k in ("__spec__", "__file__")
             if k in main.__dict__}
    main.__dict__["__spec__"] = None
    main.__dict__.pop("__file__", None)
    try:
        yield
    finally:
        main.__dict__.pop("__spec__", None)
        main.__dict__.update(saved)


def _shutdown(stop_ev, workers: List, task_q, acks: List,
              ring: Optional[ShmRing]) -> None:
    """Idempotent teardown shared by close() and the weakref finalizer.
    Must not reference the loader object (finalizer callback)."""
    try:
        stop_ev.set()
    except Exception:
        pass
    workers = [p for p in workers if p is not None]   # a failed start
    for p in workers:
        try:
            task_q.put_nowait(None)
        except Exception:
            break
    deadline = time.monotonic() + 5.0
    for p in workers:
        p.join(timeout=max(0.1, deadline - time.monotonic()))
    for p in workers:
        if p.is_alive():
            p.terminate()
            p.join(timeout=2.0)
    try:
        task_q.cancel_join_thread()
        task_q.close()
    except Exception:
        pass
    for conn in acks:
        conn.close()
    acks.clear()
    if ring is not None:
        ring.close(unlink=True)


class ShmRingLoader:
    """:class:`~.loader.HostLoader`'s drop-in, backed by worker *processes*
    and a shared-memory slab ring (the module docstring has the design).
    Yields :class:`~.loader.HostBatch` es, every batch a pure function of
    ``(seed, epoch, batch index)`` and bitwise the thread backend's.
    A ring that cannot be made (``/dev/shm`` short of space) or a worker
    that cannot start raises; nothing falls back to threads."""

    def __init__(self, dataset, sampler, batch_size: int, seed: int = 42,
                 num_workers: int = 4, ring_depth: int = 4,
                 collate_mixup: Optional[Any] = None,
                 valid_mask: bool = False,
                 heartbeat_timeout: float = 120.0,
                 prefetch_depth: int = 2, pin_memory: bool = False):
        from .loader import LoaderStats
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = max(1, int(num_workers))
        self.ring_depth = max(3, int(ring_depth))
        self.collate_mixup = collate_mixup
        self.valid_mask = valid_mask
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.prefetch_depth = max(1, int(prefetch_depth))
        self.pin_memory = pin_memory
        self.prepare = None
        self.stats = LoaderStats()
        self.epoch = 0
        # mid-epoch resume: first yielded batch of the next iteration
        # (absolute indices are kept for slot tokens and per-batch draws);
        # reset by set_epoch, as HostLoader.start_batch
        self.start_batch = 0
        self.respawn_count = 0          # lifetime total: observability/tests
        self._iter_respawns = 0         # windowed: crash-loop abort guard
        self._slow_tasks: Set[Tuple[int, int]] = set()  # kill-once ledger
        # telemetry counters (obs/telemetry.py loader_collector): lifetime
        # totals, single writer (the collector thread)
        self.stall_sweeps = 0           # lost-ack re-dispatch sweeps fired
        self.collect_wait_s = 0.0       # collector blocked waiting on a batch
        self.copy_s = 0.0               # batches copied out of their slabs
        self.inflight_batches = 0       # dispatched, not yet taken (ring
        # occupancy = inflight_batches / ring_depth)

        self._ctx = mp.get_context("spawn")
        self._ring: Optional[ShmRing] = None
        self._workers: List[Any] = []
        self._finalizer: Optional[weakref.finalize] = None
        self._active: Optional[Tuple[threading.Event, threading.Thread]] \
            = None
        self._dirty = False             # an iteration left tasks in flight
        self._splits = 1
        self._img_shape: Tuple[int, ...] = ()
        self._rows = 0

    # -- HostLoader interface parity ------------------------------------
    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.start_batch = 0
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.sampler) // self.batch_size

    # -- lifecycle ------------------------------------------------------
    def _ensure_started(self) -> None:
        if self._ring is not None:
            return
        probe_index = next(iter(self.sampler), None)
        if probe_index is None:
            raise ValueError("sampler yields no indices")
        # one probe decode in the parent fixes the slab geometry (and
        # builds or loads the native library before any worker starts);
        # the workers compute the sample again
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, self.epoch, int(probe_index)]))
        img, _ = self.dataset.__getitem__(int(probe_index), rng=rng)
        arr = np.asarray(img, dtype=np.uint8)
        if arr.ndim == 4:
            self._splits, self._img_shape = int(arr.shape[0]), arr.shape[1:]
        elif arr.ndim == 3:
            self._splits, self._img_shape = 1, arr.shape
        else:
            raise ValueError(f"sample must be (H, W, C) or (S, H, W, C), "
                             f"got shape {arr.shape}")
        self._rows = self._splits * self.batch_size
        _, need = ShmRing.layout(self.ring_depth, self._rows,
                                 self._img_shape, self.batch_size)
        free = shm_free_bytes()
        if need > free:
            # tmpfs pages past its limit fault (SIGBUS) at a worker's first
            # write, not at SharedMemory(create=True): refuse up front
            raise OSError(errno.ENOSPC,
                          f"shm ring of {self.ring_depth} slabs x "
                          f"{self._rows} rows of {tuple(self._img_shape)} "
                          f"needs {need} bytes; {SHM_DIR} has {free} free")
        self._ring = ShmRing(self.ring_depth, self._rows, self._img_shape,
                             self.batch_size, create=True)
        self._task_q = self._ctx.Queue()
        # one ack pipe a worker: a worker killed while its end of a shared
        # queue held the queue's write lock (its feeder thread mid-ack)
        # would block every other worker's acks for good; a pipe a worker
        # has no lock, and a dead worker's pipe ends in EOF after its last
        # ack.  The readers of dead workers stay until that EOF is read
        self._acks: List[Any] = []
        self._stop = self._ctx.Event()
        self._hb = self._ctx.Array("d", self.num_workers, lock=False)
        self._cur = self._ctx.Array("q", 3 * self.num_workers, lock=False)
        self._gen = self._ctx.Value("q", 0, lock=False)
        self._owner = self._ctx.Array("q", self.ring_depth, lock=False)
        # each worker's native pool gets a slice of the cores: N workers x
        # 4 default threads would oversubscribe
        self._native_threads = max(
            1, min(4, (os.cpu_count() or 1) // self.num_workers))
        self._workers = [None] * self.num_workers
        self._finalizer = weakref.finalize(
            self, _shutdown, self._stop, self._workers, self._task_q,
            self._acks, self._ring)
        try:
            for i in range(self.num_workers):
                self._spawn(i)
        except BaseException:
            # a dataset that cannot be pickled, a process that cannot
            # start: stop what started and unlink the segment, then raise
            self.close()
            raise

    def _spawn(self, i: int) -> None:
        self._hb[i] = time.monotonic()
        self._cur[3 * i] = 0
        reader, writer = self._ctx.Pipe(duplex=False)
        p = self._ctx.Process(
            target=_worker_main,
            args=(i, self.dataset, self.seed, self._ring.name,
                  self.ring_depth, self._rows, self._img_shape,
                  self.batch_size, self._task_q, writer, self._stop,
                  self._hb, self._cur, self._gen, self._owner,
                  self._native_threads),
            daemon=True, name=f"dfd-shm-worker-{i}")
        # a chaos worker kill is a TRANSIENT fault: the replacement worker
        # must not inherit the spec and die again in a loop (spawned
        # children snapshot os.environ at start)
        chaos_env = os.environ.pop(CHAOS_ENV_VAR, None) \
            if self.respawn_count else None
        try:
            with _main_hidden():
                p.start()
        except BaseException:
            reader.close()
            raise
        finally:
            # the child holds its own end now; with the parent's closed,
            # the reader sees EOF once the child has exited
            writer.close()
            if chaos_env is not None:
                os.environ[CHAOS_ENV_VAR] = chaos_env
        self._acks.append(reader)
        self._workers[i] = p

    def _recv_acks(self, timeout: float) -> List[Tuple]:
        """The acks that arrive within ``timeout`` seconds; a pipe at EOF
        (its worker exited, at most a torn last ack in it) is closed and
        dropped."""
        out = []
        for conn in mp_connection.wait(list(self._acks), timeout):
            try:
                out.append(conn.recv())
            except (EOFError, OSError):
                conn.close()
                self._acks.remove(conn)
        return out

    def _stop_active(self) -> None:
        """Stop and join the collector thread of a running iteration."""
        active, self._active = self._active, None
        if active is not None:
            active[0].set()
            active[1].join(timeout=60.0)

    def close(self) -> None:
        """Stop the collector and the workers, drain the queues, unlink the
        shm segment.  Safe to call twice; also runs through
        ``weakref.finalize`` at garbage collection or interpreter exit."""
        self._stop_active()
        if self._finalizer is not None:
            self._finalizer()
        self._ring = None
        self._workers = []

    # -- iteration ------------------------------------------------------
    def _quiesce(self) -> None:
        """After an abandoned iteration: invalidate outstanding tasks (gen
        bump), drain them, and wait for in-flight writes to land so no
        stale worker can touch a slab the new iteration dispatches."""
        self._gen.value += 1
        while True:
            try:
                self._task_q.get_nowait()
            except (queue_mod.Empty, OSError):
                break
        deadline = time.monotonic() + 30.0
        while any(self._cur[3 * i] for i in range(self.num_workers)):
            for i, p in enumerate(self._workers):
                if p.exitcode is not None and self._cur[3 * i]:
                    self._cur[3 * i] = 0      # dead: can't clear its flag
                    self.respawn_count += 1
                    self._spawn(i)
            if time.monotonic() > deadline:
                # a straggler stuck in __getitem__ on a stale task that
                # already passed its gen check would later write into a
                # slab the next iteration dispatches: kill it rather than
                # risk a silent corrupt batch
                for i, p in enumerate(self._workers):
                    if self._cur[3 * i]:
                        _logger.warning("shm worker %d still busy after "
                                        "quiesce deadline; terminating", i)
                        p.terminate()
                        p.join(timeout=5.0)
                        self.respawn_count += 1
                        self._spawn(i)
                break
            time.sleep(0.01)
        while self._recv_acks(0):
            pass
        self._dirty = False

    def _check_workers(self, done: Dict[int, Set[int]],
                       batches: List[List[int]], epoch: int,
                       gen: int) -> None:
        now = time.monotonic()
        for i in range(self.num_workers):
            p = self._workers[i]
            dead = p.exitcode is not None
            base = 3 * i
            if not dead and self._cur[base] and \
                    now - self._hb[i] > self.heartbeat_timeout:
                tkey = (int(self._cur[base + 1]), int(self._cur[base + 2]))
                if tkey in self._slow_tasks:
                    # this task already stalled a worker once; the sample
                    # is deterministic, so a re-kill loop would abort slow
                    # but healthy data: let it run to completion
                    continue
                self._slow_tasks.add(tkey)
                _logger.warning(
                    "shm worker %d silent for %.0fs on a task; killing",
                    i, now - self._hb[i])
                p.terminate()
                p.join(timeout=5.0)
                dead = True
            if not dead:
                continue
            flag, bi, j = (self._cur[base], int(self._cur[base + 1]),
                           int(self._cur[base + 2]))
            self.respawn_count += 1
            self._iter_respawns += 1
            # windowed (reset each iteration): isolated crashes over a long
            # run must not add up to an abort, only a crash loop within one
            if self._iter_respawns > 3 * self.num_workers:
                raise RuntimeError(
                    "shm loader: workers keep dying "
                    f"({self._iter_respawns} respawns this epoch); "
                    "giving up")
            _logger.warning("shm worker %d died (exitcode %s); respawning",
                            i, p.exitcode)
            self._spawn(i)
            # the dead worker held at most ONE task; everything else is
            # still queued or already acked.  Re-dispatch it unless its
            # ack made it out before the crash (a duplicate writes the
            # same bytes)
            if flag and bi in done and j < len(batches[bi]) \
                    and j not in done[bi]:
                self._task_q.put((bi % self.ring_depth, j,
                                  int(batches[bi][j]), epoch, bi, gen))

    def _collect(self, bi: int, done: Dict[int, Set[int]],
                 batches: List[List[int]], epoch: int, gen: int,
                 stop: threading.Event) -> None:
        need = len(batches[bi])
        t_enter = time.monotonic()
        last_progress = t_enter
        sweeps = 0
        while len(done.get(bi, ())) < need:
            if stop.is_set():
                raise _Stopped()
            acks = self._recv_acks(0.2)
            if not acks:
                self._check_workers(done, batches, epoch, gen)
                # lost-task net: a worker that died after taking a task
                # but before publishing its cell (the chaos kill point), or
                # halfway through writing its ack, leaves done[bi] short
                # with nothing in flight.  When the batch stalls,
                # re-dispatch its unacked samples that no live worker holds
                # (duplicates are harmless: the owner check blocks late
                # writes into a recycled slab)
                now = time.monotonic()
                if now - last_progress > max(5.0, self.heartbeat_timeout / 8):
                    sweeps += 1
                    self.stall_sweeps += 1
                    if sweeps > 20:
                        raise RuntimeError(
                            f"shm loader: batch {bi} stalled "
                            f"({len(done.get(bi, ()))}/{need} samples after "
                            f"{sweeps} re-dispatch sweeps)")
                    busy = {(int(self._cur[3 * i + 1]),
                             int(self._cur[3 * i + 2]))
                            for i in range(self.num_workers)
                            if self._cur[3 * i]}
                    for j2 in range(need):
                        if j2 not in done.get(bi, ()) and \
                                (bi, j2) not in busy:
                            self._task_q.put(
                                (bi % self.ring_depth, j2,
                                 int(batches[bi][j2]), epoch, bi, gen))
                    last_progress = now
                continue
            last_progress = time.monotonic()
            for g, dbi, j, err, fallbacks in acks:
                if g != gen:
                    continue
                if fallbacks:
                    with _dataset_mod._fallbacks_lock:
                        _dataset_mod.decode_fallbacks += fallbacks
                if err is not None:
                    raise RuntimeError(f"shm worker failed on sample {j} "
                                       f"of batch {dbi}: {err}")
                done.setdefault(dbi, set()).add(j)
        self.collect_wait_s += time.monotonic() - t_enter

    def _dispatch(self, bi: int, batches: List[List[int]], epoch: int,
                  gen: int, done: Dict[int, Set[int]],
                  stop: threading.Event) -> None:
        done.setdefault(bi, set())
        slot = bi % self.ring_depth
        # recycling gate: a worker can still be mid-write on this slot
        # under its PREVIOUS batch (a stale duplicate from a lost-ack
        # sweep, or an ack taken before the worker cleared its cell).
        # Waiting for those published tasks makes the owner re-claim
        # exclusive with in-flight writes; the worker's pre-write token
        # check covers a claim that has not published its cell yet
        deadline = time.monotonic() + 10.0
        while any(self._cur[3 * i]
                  and int(self._cur[3 * i + 1]) != bi
                  and int(self._cur[3 * i + 1]) % self.ring_depth == slot
                  for i in range(self.num_workers)):
            if stop.is_set():
                raise _Stopped()
            if time.monotonic() > deadline:
                _logger.warning("slot %d recycle gate timed out", slot)
                break
            time.sleep(0.002)
        # claim the slot for (gen, bi) BEFORE its tasks exist: workers
        # check this token right before any slab write
        self._owner[slot] = _owner_token(gen, bi)
        for j, idx in enumerate(batches[bi]):
            self._task_q.put((slot, j, int(idx), epoch, bi, gen))
        self.inflight_batches = len(done)

    def _take(self, bi: int):
        """``(images, targets)`` of batch ``bi``, copied out of its slab
        into a buffer of their own (pinned for a card), targets tiled over
        the splits."""
        import torch
        slab = self._ring.images[bi % self.ring_depth]
        t0 = time.perf_counter()
        images = torch.empty(slab.shape, dtype=torch.uint8,
                             pin_memory=self.pin_memory)
        np.copyto(images.numpy(), slab)
        targets = self._ring.targets[bi % self.ring_depth].copy()
        self.copy_s += time.perf_counter() - t0
        if self._splits > 1:
            targets = np.tile(targets, self._splits)
        return images, targets

    def _produce(self, batches, vms, start: int, gen: int, epoch: int,
                 q: "queue_mod.Queue", stop: threading.Event) -> None:
        """The collector thread: dispatch, collect, copy out, finish, and
        hand each batch to the consumer through ``q``."""
        from .loader import finish_batch

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        # loader points count batches within an epoch, as the thread
        # backend's (none unless DFD_CHAOS is set)
        chaos = chaos_from_env() if os.environ.get(CHAOS_ENV_VAR) else None
        D = self.ring_depth
        nb = len(batches)
        done: Dict[int, Set[int]] = {}
        try:
            for bi in range(start, min(start + D, nb)):
                self._dispatch(bi, batches, epoch, gen, done, stop)
            for bi in range(start, nb):
                if chaos is not None and chaos.fires("stall_loader", bi):
                    secs = chaos.arg("stall_loader", 120.0)
                    _logger.warning("chaos: stalling the loader %.0fs at "
                                    "batch %d", secs, bi)
                    stop.wait(secs)
                t0 = time.perf_counter()
                self._collect(bi, done, batches, epoch, gen, stop)
                images, targets = self._take(bi)
                done.pop(bi, None)
                # the slab is free: refill the ring
                if bi + D < nb:
                    self._dispatch(bi + D, batches, epoch, gen, done, stop)
                self.inflight_batches = len(done)
                if bi == nb - 1:
                    self._dirty = False     # every task of gen collected
                item = finish_batch(self, bi, batches[bi], images, targets,
                                    None if vms is None else vms[bi], epoch)
                self.stats.fetch_s += time.perf_counter() - t0
                self.stats.batches += 1
                if not put(item):
                    return
            put(None)
        except _Stopped:
            return
        except BaseException as e:      # raised again by the consumer
            put(e)

    def __iter__(self):
        batches, vms = epoch_batches(self.sampler, self.batch_size,
                                     self.valid_mask)
        start = self.start_batch
        if not batches or start >= len(batches):
            return
        self._stop_active()
        self._ensure_started()
        if self._dirty:
            self._quiesce()
        self._gen.value += 1
        gen = int(self._gen.value)
        self._dirty = True
        self._iter_respawns = 0
        self._slow_tasks.clear()
        q: "queue_mod.Queue" = queue_mod.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()
        thread = threading.Thread(
            target=self._produce,
            args=([list(b) for b in batches], vms, start, gen, self.epoch,
                  q, stop),
            daemon=True, name="dfd-shm-collector")
        self._active = (stop, thread)
        thread.start()
        try:
            while True:
                try:
                    item = q.get(timeout=1.0)
                except queue_mod.Empty:
                    if thread.is_alive() or not q.empty():
                        continue
                    raise RuntimeError("shm loader: the collector thread "
                                       "ended (the loader was closed)")
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=60.0)
            if self._active is not None and self._active[1] is thread:
                self._active = None
