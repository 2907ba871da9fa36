"""Message transports for the cluster control plane.

The controller and its workers speak plain-dict messages over a ``Channel``
— a tiny, directionless pipe interface with non-blocking ``recv``. Two
transports implement it:

  * ``InProcChannel`` (``inproc_pair``) — a pair of deques shared between
    the two ends. This is the *simulated-cluster* substrate: delivery is
    FIFO and happens exactly when the owning control loop pumps the peer,
    so a whole multi-worker cluster runs deterministically inside one
    process on the shared simulated clock (the same property that makes
    the serving tests assertable). Single-threaded by construction.
  * ``MpChannel`` (``mp_worker``) — wraps a ``multiprocessing`` pipe to a
    real worker process running ``worker.worker_main``. This is the
    process-isolation substrate: same messages, same worker logic, real
    pickling across the boundary. Delivery timing is wall-clock (the
    ``timeout`` of ``recv_wait`` is wall seconds; everything *inside*
    the messages stays in simulated seconds), so it is smoke-tested for
    round-trip correctness — standalone and under the ``Controller``
    (``add_remote_worker``) — rather than driven by the deterministic
    serving tests.

Messages are dicts with an ``"op"`` key (see ``worker.WorkerCore`` for the
vocabulary). In-process messages may carry live objects (``ScheduleResult``,
``CompletionReport``); the multiprocessing transport pickles them — every
payload type is a plain dataclass, so both transports carry the same
protocol unmodified.
"""
from __future__ import annotations

import collections


class ChannelClosed(Exception):
    """The peer end of a channel has been closed."""


class Channel:
    """One end of a bidirectional message pipe.

    ``send`` never blocks; ``recv`` returns the next message or None when
    the inbox is empty; ``recv_wait`` blocks up to ``timeout`` seconds for
    transports with a real peer process (in-process, where the peer only
    runs when pumped, it is equivalent to ``recv``)."""

    def send(self, msg: dict) -> None:
        raise NotImplementedError

    def recv(self) -> dict | None:
        raise NotImplementedError

    def recv_wait(self, timeout: float | None = None) -> dict | None:
        return self.recv()

    def poll(self) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InProcChannel(Channel):
    """Deque-backed channel end. ``inproc_pair`` wires two of these
    back-to-back: what one end sends, the other receives, in FIFO order.
    Not thread-safe — the whole in-process cluster is one control loop."""

    def __init__(self, inbox: collections.deque, outbox: collections.deque):
        self._inbox = inbox
        self._outbox = outbox
        self._closed = False

    def send(self, msg: dict) -> None:
        if self._closed:
            raise ChannelClosed("send on closed channel")
        self._outbox.append(msg)

    def recv(self) -> dict | None:
        return self._inbox.popleft() if self._inbox else None

    def poll(self) -> bool:
        return bool(self._inbox)

    def close(self) -> None:
        self._closed = True


def inproc_pair() -> tuple[InProcChannel, InProcChannel]:
    """A connected (controller_end, worker_end) channel pair."""
    a2b: collections.deque = collections.deque()
    b2a: collections.deque = collections.deque()
    return InProcChannel(b2a, a2b), InProcChannel(a2b, b2a)


class MpChannel(Channel):
    """Channel over a ``multiprocessing.connection.Connection``. ``recv``
    is non-blocking (None when nothing is pending); ``recv_wait`` blocks
    up to ``timeout`` wall seconds."""

    def __init__(self, conn):
        self.conn = conn

    def send(self, msg: dict) -> None:
        try:
            self.conn.send(msg)
        except (OSError, ValueError) as e:       # peer process died
            raise ChannelClosed(str(e)) from e

    def recv(self) -> dict | None:
        if not self.conn.poll(0):
            return None
        try:
            return self.conn.recv()
        except EOFError as e:
            raise ChannelClosed("peer hung up") from e

    def recv_wait(self, timeout: float | None = None) -> dict | None:
        if not self.conn.poll(timeout):
            return None
        try:
            return self.conn.recv()
        except EOFError as e:
            raise ChannelClosed("peer hung up") from e

    def poll(self) -> bool:
        return self.conn.poll(0)

    def close(self) -> None:
        self.conn.close()


def mp_worker(wid: str, pool: dict, backend: str = "analytic",
              backend_kw: dict | None = None):
    """Spawn a real worker process serving the cluster protocol over a
    pipe. Returns ``(MpChannel, Process)``; send ``{"op": "stop"}`` (or
    close the channel) and ``join()`` the process to shut down."""
    import multiprocessing as mp

    from .worker import worker_main

    # spawn, not fork: the parent may have live threads (a CUDA context,
    # test harnesses) and forking a threaded process is deadlock-prone;
    # the child opens its own CUDA context only if its backend is torch
    # on the card, and loads the kernels already built under build/
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=worker_main,
                       args=(child, wid, dict(pool), backend,
                             dict(backend_kw or {})),
                       daemon=True)
    proc.start()
    child.close()                   # the child holds its own copy
    return MpChannel(parent), proc
