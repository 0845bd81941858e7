"""The selector event-loop core of the shuffle data plane.

The port's copy of ``uda_tpu/net/evloop.py``. The socket analogue of the
reference's completion-channel epoll loop (reference
src/DataNet/RDMAComm.cc ``cm_event_handler``/``comp_event_handler``: one
thread parked in epoll over the completion channels, dispatching work
completions to per-connection state): ONE thread multiplexes every
registered socket through ``selectors.DefaultSelector`` — non-blocking
fds, per-connection state machines, no thread pair per connection, so
the supplier scales with connections, not threads.

Threading contract (the whole module is built around it):

- **loop thread**: ``select()`` + registered handlers + ``call_soon``
  callbacks run here. Handlers must never block: every registered
  callback is marked with :func:`loop_callback`, and no
  ``recv``/``sendall``/unbounded
  ``.result()``/unbounded ``queue.get()`` may appear inside one (use
  ``recv_into``/``send``/``sendmsg`` on the non-blocking fd, or move
  the work to :meth:`EventLoop.dispatch`). The loop's own run loop is
  exempt — parking in ``select()`` is its job.
- **selector mutation** (register/modify/unregister) happens ON the
  loop thread only; other threads marshal through
  :meth:`EventLoop.call_soon` (deque append + wake byte — the
  self-pipe trick), because ``selectors`` objects are not safe against
  concurrent mutation from outside ``select()``.
- **dispatcher thread**: completion *upcalls* (a Segment's
  ``on_complete``, which may legitimately block on arena admission)
  run on a separate dispatcher thread via :meth:`dispatch`, so one
  slow consumer stalls other *completions* but never the data plane
  itself — the reference's completion-channel-thread shape, where the
  epoll loop hands WCs off rather than running reducer code inline.

Backpressure note: nothing here queues unboundedly on its own — the
server's per-connection credit cap pauses *read interest* when the
pipeline is full (TCP flow control pushes back on the peer, exactly
like the threaded core's blocking reader), and dispatcher depth is
bounded by the fetch windows of the clients feeding it.
"""

from __future__ import annotations

import queue
import selectors
import socket
import threading
from collections import deque
from typing import Callable, Optional

from uda_tpu_torch.utils.locks import TrackedLock
from uda_tpu_torch.utils.logging import get_logger

__all__ = ["EventLoop", "loop_callback", "shared_client_loop"]

log = get_logger()


def loop_callback(fn):
    """Marker for functions registered as event-loop callbacks (read/
    write handlers, ``call_soon`` targets). Purely declarative — the
    decorated function is returned unchanged — but the marker is a
    contract: a marked body makes no blocking call (``recv``/
    ``sendall``/unbounded ``.result()``/unbounded ``queue.get()``) that
    would park the shared loop thread."""
    fn.__uda_loop_callback__ = True
    return fn


class EventLoop:
    """One selector thread + one completion-dispatch thread.

    Handlers are registered per socket as ``handler(mask)`` callables;
    ``call_soon(fn, *args)`` marshals work onto the loop thread from
    anywhere; ``dispatch(fn, *args)`` hands potentially-blocking
    completion upcalls to the dispatcher thread in FIFO order."""

    def __init__(self, name: str = "uda-net-loop"):
        self.name = name
        self._sel = selectors.DefaultSelector()
        self._pending: "deque[tuple[Callable, tuple]]" = deque()
        self._stopping = threading.Event()
        # SimpleQueue: the C-implemented put/get pair — the dispatcher
        # handoff sits on the completion path of every fetch, and the
        # Condition machinery of queue.Queue costs real syscalls on
        # emulated kernels
        self._dispatchq: "queue.SimpleQueue[Optional[tuple[Callable, tuple]]]" = \
            queue.SimpleQueue()
        # the wake pipe (self-pipe trick): call_soon from any thread
        # appends to the deque and sends one byte so a parked select()
        # returns immediately
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._wake_buf = bytearray(4096)  # reusable drain scratch
        self._sel.register(self._wake_r, selectors.EVENT_READ,
                           self._drain_wake)
        # sock -> handler for connections with interest mask 0 (read
        # paused for credit backpressure with nothing left to write)
        self._parked: dict = {}
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True,
                                            name=f"{name}-upcall")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "EventLoop":
        self._thread.start()
        self._dispatcher.start()
        return self

    def alive(self) -> bool:
        return self._thread.is_alive() and not self._stopping.is_set()

    def on_loop_thread(self) -> bool:
        return threading.current_thread() is self._thread

    def stop(self) -> None:
        """Stop both threads and release the selector. Sockets still
        registered are NOT closed — their owners tear them down (the
        loop never owns connection lifecycle). Straggler work queued
        after the threads exit (a late engine completion's call_soon, a
        dispatched size probe) is drained INLINE here so accounting
        callbacks (credit gauges, slice releases) always run."""
        if self._stopping.is_set():
            return
        self._stopping.set()
        self._wake()
        self._thread.join(timeout=5.0)
        self._dispatchq.put(None)
        self._dispatcher.join(timeout=5.0)
        self._run_pending()
        while True:
            try:
                item = self._dispatchq.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            fn, args = item
            try:
                fn(*args)
            except Exception as e:  # noqa: BLE001 - teardown stragglers
                log.warn(f"net: straggler completion raised during loop "
                         f"stop: {type(e).__name__}: {e}")
        self._run_pending()
        try:
            self._sel.close()
        except OSError:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()  # a plain close: the wake pipe is a
                # loop-internal socketpair, not a peer connection: no
                # reader blocks on it (the loop thread has exited) and
                # there is no peer to FIN
            except OSError:
                pass

    # -- cross-thread marshalling -------------------------------------------

    def call_soon(self, fn: Callable, *args) -> None:
        """Run ``fn(*args)`` on the loop thread at the next turn. Safe
        from any thread; deque.append is atomic, the wake byte is best
        effort (a full pipe means a wakeup is already pending)."""
        self._pending.append((fn, args))
        self._wake()

    def dispatch(self, fn: Callable, *args) -> None:
        """Run ``fn(*args)`` on the dispatcher thread (FIFO). For
        completion upcalls that may block — they must not run on the
        loop thread."""
        self._dispatchq.put((fn, args))

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, OSError):
            pass  # pipe full (wakeup already pending) or torn down

    @loop_callback
    def _drain_wake(self, mask: int) -> None:
        try:
            while self._wake_r.recv_into(self._wake_buf):
                pass
        except (BlockingIOError, OSError):
            pass

    # -- selector surface (loop thread only) --------------------------------

    def register(self, sock, events: int, handler: Callable) -> None:
        """Register ``handler(mask)`` for ``sock``. Loop thread only —
        marshal through call_soon from anywhere else."""
        self._sel.register(sock, events, handler)

    def set_events(self, sock, events: int) -> None:
        """Change the interest mask (loop thread only). ``events=0`` is
        expressed by modifying to neither flag — selectors require at
        least one, so 0 unregisters and a later set re-registers."""
        key = self._sel.get_key(sock)
        if events:
            if key.events != events:
                self._sel.modify(sock, events, key.data)
        else:
            self._sel.unregister(sock)
            self._parked[sock] = key.data

    def resume(self, sock, events: int) -> None:
        """Re-register a socket parked by ``set_events(sock, 0)``."""
        handler = self._parked.pop(sock, None)
        if handler is not None:
            self._sel.register(sock, events, handler)
        else:
            self.set_events(sock, events)

    def unregister(self, sock) -> None:
        self._parked.pop(sock, None)
        try:
            self._sel.unregister(sock)
        except KeyError:
            pass

    def registered(self, sock) -> bool:
        try:
            self._sel.get_key(sock)
            return True
        except KeyError:
            return sock in self._parked

    def stats(self) -> dict:
        """Introspection glance (the MSG_STATS conn-table provider):
        liveness plus queue depths. Racy reads by design — this is a
        console view, not a synchronization point; the selector map
        read is guarded because selectors are not safe against
        concurrent mutation (a torn read degrades to -1, never an
        exception on the poll path)."""
        try:
            registered = len(self._sel.get_map())
        except (OSError, RuntimeError):
            registered = -1
        return {"alive": self.alive(),
                "registered": registered,
                "parked": len(self._parked),
                "pending_callbacks": len(self._pending),
                "dispatch_depth": self._dispatchq.qsize()}

    # -- the loop -----------------------------------------------------------

    def _run(self) -> None:
        while not self._stopping.is_set():
            try:
                events = self._sel.select(timeout=0.25)
            except OSError:
                # fd closed under select (owner teardown race). The
                # pending queue MUST still drain: the queued unregister
                # is what removes the bad fd — skipping it busy-loops
                # non-epoll selectors (epoll auto-removes closed fds,
                # poll/select raise EBADF forever)
                self._run_pending()
                continue
            for key, mask in events:
                try:
                    key.data(mask)
                except Exception as e:  # noqa: BLE001 - a handler bug
                    # must not take down the loop under every OTHER
                    # connection; the broken connection's own teardown
                    # path is responsible for failing its requests
                    log.error(f"net: event handler died: "
                              f"{type(e).__name__}: {e}")
            self._run_pending()

    def _run_pending(self) -> None:
        # bounded by the deque length at entry: a callback that
        # re-schedules itself runs next turn, not forever in this one
        for _ in range(len(self._pending)):
            try:
                fn, args = self._pending.popleft()
            except IndexError:
                break
            try:
                fn(*args)
            except Exception as e:  # noqa: BLE001 - same survival policy
                log.error(f"net: call_soon callback died: "
                          f"{type(e).__name__}: {e}")

    def _dispatch_loop(self) -> None:
        while True:
            item = self._dispatchq.get()
            if item is None:
                return
            fn, args = item
            try:
                fn(*args)
            except Exception as e:  # noqa: BLE001 - one consumer's bug
                # must not starve every later completion of delivery
                log.warn(f"net: dispatched completion raised: "
                         f"{type(e).__name__}: {e}")


# -- the shared client loop ---------------------------------------------------

# One process-wide loop serves every RemoteFetchClient connection (the
# reference ran ONE completion-channel epoll thread for all QPs, not one
# per peer). Created lazily, daemon threads, never torn down mid-process
# — like an executor, its lifetime is the process's.
_shared: Optional[EventLoop] = None
_shared_lock = TrackedLock("net.loop")


def shared_client_loop() -> EventLoop:
    global _shared
    with _shared_lock:
        if _shared is None or not _shared.alive():
            _shared = EventLoop("uda-net-client-loop").start()
        return _shared
