"""Framed RPC transport for process-per-replica serving.

Counterpart: `paddle_tpu/serving/transport.py`, copied: the same frame
layout and limits, so one object encodes to the same bytes in both
packages.  A worker process talks to the router over a Unix socketpair
with **length-prefixed JSON frames**: a 4-byte big-endian payload
length, then the UTF-8 JSON payload.  Commands flow down
(``add_request`` / ``cancel`` / ``drain`` / ``metrics_snapshot`` /
``close``), streamed events flow up (``tok`` / ``fin`` / ``step`` /
``ready``), and every command gets exactly one ``reply`` frame; stream
events may interleave ahead of it, so readers keep dispatching events
while they wait.

* A **torn frame** (EOF mid-frame: the peer died mid-write, which is
  what ``kill -9`` during a send gives) and an **oversized frame** (a
  declared length past ``max_frame``) both raise :class:`FrameError`;
  after one the stream is unusable and the connection is torn down (the
  router turns it into a crash eviction and a failover re-prefill).
* Blocking reads run under :class:`TransportPolicy` (per-attempt
  timeout, retries, exponential backoff), so a wedged worker cannot
  wedge the router: the caller counts each expired attempt
  (``router_transport_timeouts_total``) and escalates.
* The ``serving.transport_drop`` chaos site drops a received frame in
  transit (by channel name tag), surfacing as the FrameError a real
  torn frame raises.

:class:`FrameDecoder` is a pure incremental decoder (bytes in, frames
out), so the framing rules are testable byte by byte without sockets;
:class:`Channel` wraps a socket around one.
"""
from __future__ import annotations

import collections
import json
import os
import select
import struct
import time

from ..resilience import chaos
from ..resilience.backoff import Backoff

_HEADER = struct.Struct("!I")
MAX_FRAME = 8 * 1024 * 1024     # structural upper bound per frame
_MIN_PAYLOAD = 2                # the smallest JSON object, "{}"


class TransportError(RuntimeError):
    """Base class for transport faults.  RuntimeError subclass so retry
    surfaces treat it as a transport fault, not a programming error."""


class FrameError(TransportError):
    """A structurally invalid frame: torn (EOF mid-frame), oversized,
    or undecodable payload.  The stream is unusable past this point —
    tear the connection down and let the replica-level recovery
    (eviction + failover) restore the streams."""


class TransportTimeout(TransportError):
    """A blocking read exhausted its policy budget (timeout x retries).
    The peer is wedged or unreachable — the hang analog of a torn
    frame."""


class ChannelClosed(TransportError):
    """Clean EOF at a frame boundary, or I/O on a closed channel."""


class TransportPolicy:
    """Timeout/retry policy for blocking transport reads: one
    per-attempt ``timeout``, ``retries`` extra attempts after the first,
    exponential backoff between attempts (``resilience.backoff.
    Backoff``), the shape of the JAX package's collective policy."""

    __slots__ = ("timeout", "retries", "backoff")

    def __init__(self, timeout=60.0, retries=1, backoff_base=0.05,
                 backoff_factor=2.0, backoff_max=2.0, sleep=time.sleep):
        self.timeout = float(timeout)
        self.retries = int(retries)
        self.backoff = Backoff(base=backoff_base, factor=backoff_factor,
                               max_delay=backoff_max, sleep=sleep)


def policy_from_env():
    """The transport policy from ``PADDLE_TPU_TRANSPORT_TIMEOUT`` /
    ``_RETRIES`` / ``_BACKOFF`` (defaults 60 s / 1 / 0.05 s)."""
    return TransportPolicy(
        timeout=float(os.environ.get("PADDLE_TPU_TRANSPORT_TIMEOUT",
                                     "60")),
        retries=int(os.environ.get("PADDLE_TPU_TRANSPORT_RETRIES", "1")),
        backoff_base=float(os.environ.get("PADDLE_TPU_TRANSPORT_BACKOFF",
                                          "0.05")))


def encode(obj, max_frame=MAX_FRAME):
    """One wire frame for `obj`.  Raises FrameError when the payload
    exceeds `max_frame` — the sender must refuse what the receiver
    would reject."""
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(payload) > max_frame:
        raise FrameError(f"frame too large to send: {len(payload)} "
                         f"bytes > max_frame={max_frame}")
    return _HEADER.pack(len(payload)) + payload


class FrameDecoder:
    """Incremental length-prefixed frame decoder.  Pure — feed it byte
    chunks split anywhere (the property test drives it with seeded
    random split points) and it yields complete frames; `close()` at
    EOF raises FrameError if bytes are buffered mid-frame (a torn
    final frame).  After any FrameError the decoder (like the stream)
    is dead by contract."""

    def __init__(self, max_frame=MAX_FRAME):
        self.max_frame = int(max_frame)
        self._buf = bytearray()

    @property
    def pending(self):
        """Bytes buffered toward an incomplete frame."""
        return len(self._buf)

    def feed(self, data):
        """Absorb `data`; return every frame completed by it."""
        self._buf += data
        out = []
        while len(self._buf) >= _HEADER.size:
            (n,) = _HEADER.unpack_from(self._buf)
            if n > self.max_frame:
                raise FrameError(f"oversized frame: {n} bytes declared, "
                                 f"limit {self.max_frame}")
            if n < _MIN_PAYLOAD:
                raise FrameError(f"malformed frame: {n}-byte payload")
            if len(self._buf) < _HEADER.size + n:
                break
            payload = bytes(self._buf[_HEADER.size:_HEADER.size + n])
            del self._buf[:_HEADER.size + n]
            try:
                out.append(json.loads(payload.decode("utf-8")))
            except (UnicodeDecodeError, ValueError) as e:
                raise FrameError(
                    f"undecodable frame payload ({e})") from e
        return out

    def close(self):
        """EOF: raise FrameError when the stream tore mid-frame."""
        if self._buf:
            raise FrameError(f"torn frame: EOF with {len(self._buf)} "
                             f"byte(s) buffered mid-frame")


class Channel:
    """One framed duplex stream over a (blocking) socket.

    Reads never block unless asked to: `poll()` drains only what the
    kernel already buffered, `recv(timeout)` waits for at most one
    deadline.  Policy-level waiting (timeout x retries x backoff) is
    the caller's job — it owns the counters and the escalation."""

    def __init__(self, sock, name="", max_frame=MAX_FRAME):
        self.sock = sock
        self.name = name
        self.max_frame = int(max_frame)
        self._dec = FrameDecoder(max_frame=max_frame)
        self._q = collections.deque()
        self._eof = False
        self.closed = False

    def fileno(self):
        return self.sock.fileno()

    def send(self, obj):
        if self.closed:
            raise ChannelClosed(f"channel {self.name!r} is closed")
        data = encode(obj, max_frame=self.max_frame)
        try:
            self.sock.sendall(data)
        except OSError as e:
            raise ChannelClosed(f"send on {self.name!r} failed: "
                                f"{e}") from e

    def wait_readable(self, timeout):
        """True when a frame (or EOF) is probably ready within
        `timeout` seconds."""
        if self._q or self._eof or self._dec.pending:
            return True
        r, _, _ = select.select([self.sock], [], [], max(0.0, timeout))
        return bool(r)

    def _fill(self):
        while not self._eof:
            r, _, _ = select.select([self.sock], [], [], 0)
            if not r:
                break
            try:
                data = self.sock.recv(65536)
            except OSError as e:
                raise ChannelClosed(f"recv on {self.name!r} failed: "
                                    f"{e}") from e
            if not data:
                self._eof = True
                self._dec.close()   # raises FrameError on a torn tail
                break
            self._q.extend(self._dec.feed(data))

    def poll(self):
        """One decoded frame, or None when nothing is buffered.  Never
        blocks.  Raises FrameError on torn/oversized/undecodable
        frames (and on an injected ``serving.transport_drop``),
        ChannelClosed at clean EOF."""
        if self.closed:
            raise ChannelClosed(f"channel {self.name!r} is closed")
        self._fill()
        if self._q:
            msg = self._q.popleft()
            if chaos.fire("serving.transport_drop", tag=self.name):
                raise FrameError(
                    f"chaos: frame dropped in transit on channel "
                    f"{self.name!r} (serving.transport_drop)")
            return msg
        if self._eof:
            raise ChannelClosed(f"peer closed channel {self.name!r}")
        return None

    def recv(self, timeout=None):
        """Block up to `timeout` seconds for one frame; None on
        timeout.  Same raises as `poll()`."""
        deadline = None if timeout is None else \
            time.monotonic() + float(timeout)
        while True:
            msg = self.poll()
            if msg is not None:
                return msg
            left = None if deadline is None else \
                deadline - time.monotonic()
            if left is not None and left <= 0:
                return None
            self.wait_readable(0.1 if left is None else min(left, 0.1))

    def close(self):
        self.closed = True
        try:
            self.sock.close()
        except OSError:
            pass
