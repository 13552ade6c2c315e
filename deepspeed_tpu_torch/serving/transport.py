"""Cross-process KV transport: the serving fleet's real wire (the port's
counterpart of ``deepspeed_tpu/serving/transport.py``; the frames, ops and
replies are the JAX package's, byte for byte, so a proxy of either package
drives a server of the other).

Everything the single-process fleet does — bit-identical KV migration,
disaggregated prefill→decode streaming, breaker-led evacuation — keeps
the bundle in one process.  This module puts the DSTPUKV2 wire format (``kv_transfer.bundle_to_bytes`` /
``bundle_from_bytes``: versioned, CRC-per-page, deadline re-based
across clock domains) on an actual socket, so a replica can live in
another process (or, over TCP, another host) behind the SAME engine
surface the router already schedules on.

Pieces:

* **Frame protocol** — length-prefixed frames on a stream socket, one
  byte of frame kind (``J`` json control / ``B`` bundle bytes) + 8-byte
  LE length + payload.  A request is a json op frame, optionally
  followed by one bundle frame; the reply mirrors that.  Bundle
  payloads are raw :func:`~.kv_transfer.bundle_to_bytes` output — the
  per-page CRC32s ride inside, and the receiving side ALWAYS re-runs
  ``bundle_from_bytes``'s integrity pass, so a torn, truncated, or
  bit-flipped frame is refused with :class:`CorruptBundleError` naming
  the page, and the sender keeps the sequence (the migration contract,
  now across processes).
* **:class:`BundleSender`** — the client side of one connection.  ALL
  socket I/O (connect, send, recv) lives on ONE dedicated sender
  thread; callers enqueue requests on a bounded queue and wait on a
  completion.  That single design choice buys three things: the
  engine/router hot path never touches a blocking socket call (the
  ``socket-hot`` lint rule enforces this shape), sends are async — the
  bounded queue IS the double buffer, bundle N rides the wire while
  N+1 serializes (:func:`pipelined_migrate`) — and connect/send
  failures retry on a BOUNDED, seeded, exponential backoff schedule
  mirroring the ``resilience/`` elastic-agent policy: a dead peer
  costs ``connect_retries`` attempts, never an infinite reconnect
  loop.
* **:class:`RemoteEngineProxy`** — an engine-shaped facade over a
  sender: ``put`` / ``step`` / ``export_sequence`` /
  ``import_sequence`` / ``drain`` / ``abort_all`` /
  ``assert_no_leaks`` … with the same signatures and refusal semantics
  as ``InferenceEngineV2``, so :class:`~.replica.EngineReplica` and
  the router schedule a cross-process replica with ZERO special
  cases.  ``migrate_sequence(local_engine, proxy, uid)`` just works —
  export here, CRC-verified import over there, release only on the
  ACK.
* **:class:`EngineServer` / :func:`spawn_engine_server`** — the child
  process: rebuilds an identical engine from a spec (same model size,
  the same weights drawn from the spec's seed on the spec's device —
  weights are never shipped), binds the socket, and serves ops until
  shutdown.  The child runs on ``cuda`` unless the spec says ``"cpu"``;
  a child whose CUDA initialisation or engine build fails exits non-zero
  and :func:`spawn_engine_server` raises :class:`TransportError`.

Single-process fleets never open a socket — the transport only
activates when a replica is spawned remote (stand-down matrix in
docs/SERVING.md "Cross-process fleet").
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue as queue_mod
import random
import socket
import sys
import tempfile
import threading
import time
import types
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..telemetry import get_registry
from ..telemetry.spans import record_event
from ..utils.logging import logger
from .config import TransportConfig
from .kv_transfer import CorruptBundleError, bundle_from_bytes, \
    bundle_to_bytes

_FRAME_JSON = b"J"
_FRAME_BUNDLE = b"B"
#: frame sanity bound: a tiny-model KV bundle is ~1 MB; 1 GiB means a
#: desynchronized stream, not a real payload
_MAX_FRAME = 1 << 30


class TransportError(RuntimeError):
    """The transport layer failed (connect retries exhausted, peer
    closed mid-frame, desynchronized stream).  Distinct from
    :class:`CorruptBundleError` — which means the bytes ARRIVED but
    failed integrity — so callers can retry transport faults while
    treating corruption as a refusal."""


# ---------------------------------------------------------------- metrics
class _Metrics:
    """``deepspeed_tpu_serving_transport_*`` family (single owner: this
    module; docs/OBSERVABILITY.md catalogs every row)."""

    _instance: Optional["_Metrics"] = None

    def __init__(self) -> None:
        reg = get_registry()
        self.frames_sent = reg.counter(
            "deepspeed_tpu_serving_transport_frames_sent_total",
            "frames written to a transport socket (control + bundle)")
        self.frames_recv = reg.counter(
            "deepspeed_tpu_serving_transport_frames_recv_total",
            "frames read off a transport socket (control + bundle)")
        self.bytes_sent = reg.counter(
            "deepspeed_tpu_serving_transport_bytes_sent_total",
            "payload bytes written to transport sockets")
        self.bytes_recv = reg.counter(
            "deepspeed_tpu_serving_transport_bytes_recv_total",
            "payload bytes read off transport sockets")
        self.connect_attempts = reg.counter(
            "deepspeed_tpu_serving_transport_connect_attempts_total",
            "socket connect attempts (bounded retry/backoff; one "
            "healthy session = one attempt)")
        self.connect_failures = reg.counter(
            "deepspeed_tpu_serving_transport_connect_failures_total",
            "connect attempts that failed and entered backoff")
        self.refused_bundles = reg.counter(
            "deepspeed_tpu_serving_transport_refused_bundles_total",
            "bundle frames refused on arrival (CRC mismatch / torn "
            "frame): the sender keeps the sequence, nothing is lost")
        self.rpc_seconds = reg.histogram(
            "deepspeed_tpu_serving_transport_rpc_seconds",
            "one request->reply round trip over the sender thread "
            "(enqueue to completion)")
        self.inflight = reg.gauge(
            "deepspeed_tpu_serving_transport_inflight_sends",
            "requests queued or on the wire in sender threads (the "
            "double-buffer depth actually in use)")

    @classmethod
    def get(cls) -> "_Metrics":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance


# ---------------------------------------------------------- frame protocol
def send_frame(sock: socket.socket, kind: bytes, payload: bytes) -> None:
    """One length-prefixed frame: kind byte + 8-byte LE length + payload."""
    sock.sendall(kind + len(payload).to_bytes(8, "little") + payload)
    m = _Metrics.get()
    m.frames_sent.inc()
    m.bytes_sent.inc(len(payload))


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise TransportError(
                f"peer closed mid-frame ({len(buf)}/{n} bytes arrived)")
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Tuple[bytes, bytes]:
    """Read one frame; returns ``(kind, payload)``.  A bad kind byte or
    an absurd length means the stream desynchronized (torn peer) —
    :class:`TransportError`, tear the connection down."""
    head = recv_exact(sock, 9)
    kind = head[:1]
    n = int.from_bytes(head[1:], "little")
    if kind not in (_FRAME_JSON, _FRAME_BUNDLE):
        raise TransportError(f"desynchronized stream: frame kind {kind!r}")
    if n > _MAX_FRAME:
        raise TransportError(f"desynchronized stream: frame length {n}")
    payload = recv_exact(sock, n)
    m = _Metrics.get()
    m.frames_recv.inc()
    m.bytes_recv.inc(len(payload))
    return kind, payload


def _connect(address: Any, timeout: float) -> socket.socket:
    if isinstance(address, str):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    else:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(timeout)
    sock.connect(address if isinstance(address, str) else tuple(address))
    return sock


# ------------------------------------------------------------- the sender
class _Pending:
    """Completion handle for one in-flight request (the double-buffer
    token :func:`pipelined_migrate` overlaps on)."""

    __slots__ = ("_event", "reply", "blob", "error", "_t0")

    def __init__(self) -> None:
        self._event = threading.Event()
        self.reply: Optional[Dict[str, Any]] = None
        self.blob: Optional[bytes] = None
        self.error: Optional[BaseException] = None
        self._t0 = time.perf_counter()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None
             ) -> Tuple[Dict[str, Any], Optional[bytes]]:
        if not self._event.wait(timeout):
            raise TransportError("request timed out awaiting its reply")
        _Metrics.get().rpc_seconds.observe(time.perf_counter() - self._t0)
        if self.error is not None:
            raise self.error
        assert self.reply is not None
        return self.reply, self.blob

    def _resolve(self, reply=None, blob=None, error=None) -> None:
        self.reply, self.blob, self.error = reply, blob, error
        self._event.set()


class BundleSender:
    """Client side of one transport connection; ALL socket I/O on one
    sender thread (see module docstring for why).  ``sleep`` is
    injectable so tests assert the bounded backoff schedule without
    waiting it out."""

    def __init__(self, address: Any,
                 config: Optional[TransportConfig] = None, *,
                 seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        self.address = address
        self.config = config or TransportConfig()
        self._rand = random.Random(seed)
        self._sleep = sleep
        self._q: "queue_mod.Queue" = queue_mod.Queue(
            maxsize=self.config.sender_depth)
        self._sock: Optional[socket.socket] = None
        self._closed = False
        #: lifetime connect attempts (tests assert boundedness)
        self.connect_attempts = 0
        self.backoffs_taken: List[float] = []
        self._thread = threading.Thread(
            target=self._run, name="dstpu-transport-sender", daemon=True)
        self._thread.start()

    # -- public API (any thread) -------------------------------------------
    def request(self, op: Dict[str, Any], payload: Optional[bytes] = None,
                timeout: Optional[float] = None
                ) -> Tuple[Dict[str, Any], Optional[bytes]]:
        """Blocking request->reply round trip."""
        return self.request_async(op, payload).wait(timeout)

    def request_async(self, op: Dict[str, Any],
                      payload: Optional[bytes] = None) -> _Pending:
        """Enqueue and return immediately — the completion handle is
        the async double-buffer token: sequence N's bundle rides the
        wire (or waits its turn in the bounded queue) while the caller
        prepares N+1."""
        if self._closed:
            raise TransportError("sender is closed")
        pending = _Pending()
        _Metrics.get().inflight.inc()
        self._q.put((op, payload, pending))
        return pending

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=10.0)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- sender thread ------------------------------------------------------
    def _backoff_delay(self, failures: int) -> float:
        """Elastic-agent schedule: exponential, capped, seeded jitter."""
        cfg = self.config
        delay = min(cfg.backoff_base_s * (2 ** max(0, failures - 1)),
                    cfg.backoff_max_s)
        return delay * (1.0 + cfg.backoff_jitter * self._rand.random())

    def _ensure_connected(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        m = _Metrics.get()
        self.connect_attempts += 1
        m.connect_attempts.inc()
        sock = _connect(self.address, self.config.io_timeout_s)
        self._sock = sock
        record_event("transport_connect", cat="serve",
                     address=str(self.address),
                     attempts=self.connect_attempts)
        return sock

    def _teardown(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _run(self) -> None:
        m = _Metrics.get()
        while True:
            item = self._q.get()
            if item is None:
                return
            op, payload, pending = item
            failures = 0
            while True:
                try:
                    sock = self._ensure_connected()
                    frame = dict(op)
                    frame["bundle_follows"] = payload is not None
                    send_frame(sock, _FRAME_JSON,
                               json.dumps(frame).encode())
                    if payload is not None:
                        send_frame(sock, _FRAME_BUNDLE, payload)
                    kind, data = recv_frame(sock)
                    if kind != _FRAME_JSON:
                        raise TransportError(
                            "desynchronized stream: reply must open with "
                            "a control frame")
                    reply = json.loads(data.decode())
                    blob = None
                    if reply.get("bundle_follows"):
                        kind, blob = recv_frame(sock)
                        if kind != _FRAME_BUNDLE:
                            raise TransportError(
                                "desynchronized stream: flagged bundle "
                                "frame missing")
                    m.inflight.dec()
                    pending._resolve(reply=reply, blob=blob)
                    break
                except (OSError, TransportError) as e:
                    # transport fault: tear down, bounded backoff, retry
                    # the WHOLE request (strict request->reply framing
                    # means a torn exchange left no partial state worth
                    # resuming)
                    self._teardown()
                    failures += 1
                    m.connect_failures.inc()
                    if failures >= self.config.connect_retries:
                        m.inflight.dec()
                        pending._resolve(error=TransportError(
                            f"transport to {self.address!r} failed after "
                            f"{failures} bounded attempts: {e}"))
                        break
                    delay = self._backoff_delay(failures)
                    self.backoffs_taken.append(delay)
                    self._sleep(delay)


# -------------------------------------------------------- the engine proxy
class _RemoteAllocator:
    """Pool-occupancy view of the remote engine (what ``load()`` /
    ``kv_free_fraction()`` / admission's ``estimate_pages`` read)."""

    def __init__(self, proxy: "RemoteEngineProxy"):
        self._proxy = proxy

    @property
    def free_pages(self) -> int:
        return int(self._proxy._stats()["free_pages"])

    @property
    def num_pages(self) -> int:
        return int(self._proxy._stats()["num_pages"])


class RemoteEngineProxy:
    """Engine-shaped facade over a :class:`BundleSender` — the router
    and :class:`~.replica.EngineReplica` schedule a cross-process
    replica through this with zero special cases.  Refusal semantics
    mirror the engine exactly: ``RejectedError`` re-raises with its
    reason/retry hint, a corrupt bundle raises
    :class:`CorruptBundleError` naming the page, ``import_sequence``
    returns False on capacity (never loses the source), and
    ``assert_no_leaks`` re-raises the remote ``AssertionError``."""

    def __init__(self, address: Any,
                 config: Optional[TransportConfig] = None, *,
                 seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        self._sender = BundleSender(address, config, seed=seed, sleep=sleep)
        self.trace_owner = "remote"  # EngineReplica re-stamps this
        self.kv_tier = None  # host tier lives in the REMOTE process
        hello, _ = self._sender.request({"op": "hello"})
        self._check(hello)
        self.block = types.SimpleNamespace(
            page_size=int(hello["page_size"]))
        self.max_seq_len = int(hello["max_seq_len"])
        self.allocator = _RemoteAllocator(self)
        self._stats_cache: Optional[Dict[str, Any]] = None

    # -- plumbing -----------------------------------------------------------
    @staticmethod
    def _check(reply: Dict[str, Any]) -> Dict[str, Any]:
        err = reply.get("err")
        if err is None:
            return reply
        msg = reply.get("msg", "")
        if err == "rejected":
            from .admission import RejectedError

            raise RejectedError(reply.get("reason", "remote"),
                                retry_after_s=float(
                                    reply.get("retry_after_s", 1.0)),
                                priority=reply.get("priority"))
        if err == "corrupt":
            _Metrics.get().refused_bundles.inc()
            raise CorruptBundleError(msg)
        if err == "value":
            raise ValueError(msg)
        if err == "key":
            raise KeyError(msg)
        if err == "assert":
            raise AssertionError(msg)
        raise RuntimeError(f"remote engine error: {msg}")

    def _rpc(self, op: Dict[str, Any], payload: Optional[bytes] = None
             ) -> Tuple[Dict[str, Any], Optional[bytes]]:
        reply, blob = self._sender.request(op, payload)
        self._stats_cache = None  # any op can change remote load
        return self._check(reply), blob

    def _stats(self) -> Dict[str, Any]:
        # one RPC serves the queue_depth/active_count/allocator reads a
        # single router pump makes back to back
        if self._stats_cache is None:
            reply, _ = self._sender.request({"op": "stats"})
            self._stats_cache = self._check(reply)
        return self._stats_cache

    # -- the engine surface -------------------------------------------------
    def put(self, request: Any, *, record_shed: bool = True) -> int:
        reply, _ = self._rpc({
            "op": "put", "record_shed": bool(record_shed),
            "request": {
                "prompt_ids": list(map(int, request.prompt_ids)),
                "max_new_tokens": request.max_new_tokens,
                "temperature": request.temperature,
                "eos_id": request.eos_id, "uid": request.uid,
                "priority": request.priority,
                "deadline_s": request.deadline_s,
                "trace_id": request.trace_id}})
        return int(reply["uid"])

    def has_work(self) -> bool:
        return bool(self._stats()["has_work"])

    @property
    def queue_depth(self) -> int:
        return int(self._stats()["queue_depth"])

    @property
    def active_count(self) -> int:
        return int(self._stats()["active_count"])

    def inflight_uids(self) -> List[int]:
        return [int(u) for u in self._stats()["inflight_uids"]]

    def ready_uids(self) -> List[int]:
        reply, _ = self._rpc({"op": "ready_uids"})
        return [int(u) for u in reply["uids"]]

    def step(self) -> Dict[int, Dict[str, Any]]:
        reply, _ = self._rpc({"op": "step"})
        return {int(u): r for u, r in reply["out"].items()}

    def export_sequence(self, uid: int) -> Any:
        """Pull one sequence across the wire.  The bundle frame is the
        serialized DSTPUKV2 record; ``bundle_from_bytes`` HERE re-runs
        the full integrity pass — the receiving side of the wire always
        re-verifies the CRCs, whichever direction the bundle flows."""
        reply, blob = self._rpc({"op": "export", "uid": int(uid)})
        if blob is None:
            raise TransportError("export reply carried no bundle frame")
        bundle = bundle_from_bytes(blob)
        record_event("transport_export", cat="serve", uid=int(uid),
                     nbytes=len(blob),
                     **({} if bundle.trace is None else
                        {"trace_id": bundle.trace.get("trace_id")}))
        return bundle

    def import_sequence(self, bundle: Any) -> bool:
        """Push one sequence across the wire (blocking).  Serialization
        happens here; the server side re-verifies every page CRC before
        adopting — a refused import leaves the remote engine untouched
        and this side still owns the sequence."""
        return self.import_commit(self.import_begin(bundle))

    def import_begin(self, bundle: Any) -> _Pending:
        """Async half of the double-buffered handoff: serialize and
        enqueue, return immediately.  The caller overlaps the next
        sequence's export/prefill with this one's wire time, then
        reaps the ACK via :meth:`import_commit`."""
        blob = bundle_to_bytes(bundle)
        pending = self._sender.request_async({"op": "import"}, blob)
        record_event("transport_import_begin", cat="serve",
                     uid=bundle.uid, nbytes=len(blob),
                     **({} if bundle.trace is None else
                        {"trace_id": bundle.trace.get("trace_id")}))
        return pending

    def import_commit(self, pending: _Pending,
                      timeout: Optional[float] = None) -> bool:
        reply, _ = pending.wait(timeout)
        self._stats_cache = None
        return bool(self._check(reply)["ok"])

    def release_sequence(self, uid: int, reason: str = "migrated") -> None:
        self._rpc({"op": "release", "uid": int(uid), "reason": reason})

    def abort_all(self, reason: str = "abort") -> List[int]:
        reply, _ = self._rpc({"op": "abort_all", "reason": reason})
        return [int(u) for u in reply["uids"]]

    def drain(self, max_steps: int = 10_000) -> Dict[str, Any]:
        reply, _ = self._rpc({"op": "drain", "max_steps": int(max_steps)})
        fin = {int(u): types.SimpleNamespace(**s)
               for u, s in reply["finished"].items()}
        pend = [types.SimpleNamespace(**s) for s in reply["pending"]]
        return {"finished": fin, "pending": pend}

    def assert_no_leaks(self) -> None:
        self._rpc({"op": "assert_no_leaks"})

    def close(self) -> None:
        """Close the REMOTE engine and shut the server loop down, then
        the local sender."""
        try:
            self._rpc({"op": "shutdown"})
        except (TransportError, RuntimeError):
            pass  # peer already gone — that is what shutdown wants
        self._sender.close()


def pipelined_migrate(src_engine: Any, proxy: RemoteEngineProxy,
                      uids: List[int]) -> int:
    """Stream several sequences to a remote engine with the double
    buffer engaged: while sequence N's bundle rides the wire, N+1 is
    exported (the prefill→decode handoff of N overlaps the prefill of
    N+1 — the reason the sender is async at all).  Each source
    sequence is released ONLY on its individual ACK, so a refused or
    torn import of any one sequence loses nothing.  Returns how many
    sequences moved."""
    inflight: List[Tuple[int, Any, _Pending]] = []
    moved = 0

    def _reap(entry) -> int:
        uid, bundle, pending = entry
        try:
            ok = proxy.import_commit(pending)
        except (CorruptBundleError, TransportError, ValueError) as e:
            logger.warning(f"pipelined_migrate: uid {uid} refused "
                           f"({e}); sequence stays on the source")
            return 0
        if not ok:
            return 0
        src_engine.release_sequence(uid, reason="migrated")
        record_event("transport_handoff", cat="serve", uid=uid,
                     pages=bundle.n_pages,
                     **({} if bundle.trace is None else
                        {"trace_id": bundle.trace.get("trace_id")}))
        return bundle.n_pages

    for uid in uids:
        bundle = src_engine.export_sequence(uid)
        inflight.append((uid, bundle, proxy.import_begin(bundle)))
        # reap ACKs behind the double-buffer horizon so at most
        # sender_depth bundles are in flight and releases stay ordered
        while len(inflight) >= max(1, proxy._sender.config.sender_depth):
            moved += 1 if _reap(inflight.pop(0)) else 0
    while inflight:
        moved += 1 if _reap(inflight.pop(0)) else 0
    return moved


# ------------------------------------------------------------- the server
class EngineServer:
    """Receiver side: owns an engine and serves ops off one connection.
    ALL socket I/O stays on the thread running :meth:`serve` — the
    receiver thread, never an engine step root (the engine only steps
    when a ``step`` frame asks it to)."""

    def __init__(self, engine: Any, listener: socket.socket):
        self.engine = engine
        self.listener = listener

    def serve(self) -> None:
        conn, _ = self.listener.accept()
        try:
            self._serve_conn(conn)
        finally:
            try:
                conn.close()
            finally:
                self.listener.close()

    def _serve_conn(self, conn: socket.socket) -> None:
        while True:
            try:
                kind, data = recv_frame(conn)
            except TransportError:
                return  # peer went away: the engine outlives the wire
            if kind != _FRAME_JSON:
                return  # desynchronized: nothing sane to reply
            op = json.loads(data.decode())
            blob = None
            if op.get("bundle_follows"):
                _, blob = recv_frame(conn)
            try:
                reply, out_blob = self._dispatch(op, blob)
            except Exception as e:  # noqa: BLE001 — every engine error
                # must cross the wire typed, not kill the server
                reply, out_blob = self._error_reply(e), None
            reply["bundle_follows"] = out_blob is not None
            send_frame(conn, _FRAME_JSON, json.dumps(reply).encode())
            if out_blob is not None:
                send_frame(conn, _FRAME_BUNDLE, out_blob)
            if op.get("op") == "shutdown":
                return

    @staticmethod
    def _error_reply(e: BaseException) -> Dict[str, Any]:
        from .admission import RejectedError

        if isinstance(e, RejectedError):
            return {"err": "rejected", "reason": e.reason,
                    "retry_after_s": e.retry_after_s,
                    "priority": e.priority, "msg": str(e)}
        if isinstance(e, CorruptBundleError):
            _Metrics.get().refused_bundles.inc()
            return {"err": "corrupt", "msg": str(e)}
        if isinstance(e, ValueError):
            return {"err": "value", "msg": str(e)}
        if isinstance(e, KeyError):
            return {"err": "key", "msg": str(e)}
        if isinstance(e, AssertionError):
            return {"err": "assert", "msg": str(e)}
        logger.error(f"EngineServer: op failed: {e!r}")
        return {"err": "runtime", "msg": f"{type(e).__name__}: {e}"}

    def _dispatch(self, op: Dict[str, Any], blob: Optional[bytes]
                  ) -> Tuple[Dict[str, Any], Optional[bytes]]:
        eng = self.engine
        name = op.get("op")
        if name == "hello":
            return {"page_size": eng.block.page_size,
                    "max_seq_len": eng.max_seq_len}, None
        if name == "stats":
            return {"queue_depth": eng.queue_depth,
                    "active_count": eng.active_count,
                    "has_work": eng.has_work(),
                    "inflight_uids": eng.inflight_uids(),
                    "free_pages": eng.allocator.free_pages,
                    "num_pages": eng.allocator.num_pages}, None
        if name == "put":
            from ..inference.v2 import RaggedRequest

            r = op["request"]
            uid = eng.put(RaggedRequest(
                prompt_ids=list(r["prompt_ids"]),
                max_new_tokens=r["max_new_tokens"],
                temperature=r["temperature"], eos_id=r["eos_id"],
                uid=r["uid"], priority=r["priority"],
                deadline_s=r["deadline_s"], trace_id=r["trace_id"]),
                record_shed=bool(op.get("record_shed", True)))
            return {"uid": uid}, None
        if name == "step":
            out = eng.step()
            return {"out": {str(u): r for u, r in out.items()}}, None
        if name == "ready_uids":
            return {"uids": eng.ready_uids()}, None
        if name == "export":
            bundle = eng.export_sequence(op["uid"])
            return {"ok": True}, bundle_to_bytes(bundle)
        if name == "import":
            if blob is None:
                raise ValueError("import op arrived without its bundle "
                                 "frame")
            # the receiving side ALWAYS re-verifies: per-page CRCs, the
            # trace block's own CRC, and the deadline transit clamp all
            # run here, before anything is adopted
            bundle = bundle_from_bytes(blob)
            return {"ok": eng.import_sequence(bundle)}, None
        if name == "release":
            eng.release_sequence(op["uid"],
                                 reason=op.get("reason", "migrated"))
            return {"ok": True}, None
        if name == "abort_all":
            return {"uids": eng.abort_all(op.get("reason", "abort"))}, None
        if name == "drain":
            res = eng.drain(op.get("max_steps", 10_000))
            ser = lambda s: {  # noqa: E731
                "uid": s.uid, "tokens": list(map(int, s.tokens)),
                "prompt_len": s.prompt_len,
                "finish_reason": getattr(s, "finish_reason", None)}
            return {"finished": {str(u): ser(s)
                                 for u, s in res["finished"].items()},
                    "pending": [ser(s) for s in res["pending"]]}, None
        if name == "assert_no_leaks":
            eng.assert_no_leaks()
            return {"ok": True}, None
        if name == "shutdown":
            eng.close()
            return {"ok": True}, None
        raise ValueError(f"unknown transport op {name!r}")


def _server_main(spec: Dict[str, Any], address: str) -> None:
    """Child-process entry: rebuild an identical engine from the spec
    (weights re-drawn from the spec's seed on its device by
    ``router.fleet_params``, as ``build_fleet`` draws them — never
    shipped), bind, serve.  Top-level so ``spawn`` can import it.

    ``spec["device"]``: ``"cuda"`` unless it says ``"cpu"``.  With
    ``spec["report_path"]`` the child writes there, after the server loop
    ends, a json record of its kernel wrappers' launch counts while it
    served (zeroed once the engine is built; the
    parent's counters cannot see a child's launches) beside its engine's
    ``stats()``, the kernel libraries it compiled (none, when the parent
    built them first), the seconds its weights and its engine (the
    CUDA-graph captures included) took, and the top-level packages it
    loaded.  Nothing of it travels on
    the wire."""
    from ..inference.v2 import InferenceEngineV2, RaggedInferenceConfig
    from ..models.llama import llama_model
    from ..ops import flash_attention, op_builder, paged_attention
    from .router import fleet_params

    device = spec.get("device") or "cuda"
    seed = int(spec.get("seed", 0))
    model = llama_model(spec.get("model", "tiny"),
                        max_seq_len=spec.get("max_seq_len", 128))
    cfg = RaggedInferenceConfig.from_dict(spec.get("engine_config") or {})
    t0 = time.perf_counter()
    params = fleet_params(model, None, cfg.torch_dtype, device, seed)
    t1 = time.perf_counter()
    engine = InferenceEngineV2(model, cfg, params=params, seed=seed, device=device)
    t2 = time.perf_counter()
    # the report counts what the server's ops launched, not the engine's
    # construction (its programs' warm-up runs)
    flash_attention.flash_attention_fwd.launches = 0
    paged_attention.paged_decode_attention.launches = 0
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(address)
    listener.listen(1)
    EngineServer(engine, listener).serve()
    path = spec.get("report_path")
    if path:
        report = {"launches": {
            "flash_attention_fwd": flash_attention.flash_attention_fwd.launches,
            "paged_decode_attention": paged_attention.paged_decode_attention.launches},
            "compiled": sorted(op_builder.build_log), "device": str(engine.device),
            "weights_s": t1 - t0, "engine_s": t2 - t1, "stats": engine.stats(),
            "packages": sorted({m.split(".")[0] for m in list(sys.modules)})}
        with open(path, "w") as f:
            json.dump(report, f)


def spawn_engine_server(spec: Dict[str, Any], *,
                        address: Optional[str] = None,
                        wait_for_socket_s: float = 180.0
                        ) -> Tuple[Any, str]:
    """Spawn a child-process engine replica; returns ``(process,
    address)`` once the child's listener is bound.  Always the ``spawn``
    start method — a forked CUDA context is undefined behavior.  The
    child binds its socket only AFTER its engine is built, so the bounded
    wait here doubles as the ready handshake (a cold torch import plus
    engine construction can take tens of seconds on a busy host); the
    transport's own bounded backoff then covers only genuine transport
    faults.  A child that dies during start-up raises
    :class:`TransportError`, as does one that binds no socket in time
    (it is terminated first)."""
    import multiprocessing

    cfg = spec.get("engine_config")
    if cfg is not None and dataclasses.is_dataclass(cfg):
        spec = dict(spec)
        spec["engine_config"] = cfg.to_dict() if hasattr(cfg, "to_dict") \
            else dataclasses.asdict(cfg)
    if address is None:
        address = os.path.join(
            tempfile.mkdtemp(prefix="dstpu_transport_"), "engine.sock")
    ctx = multiprocessing.get_context("spawn")
    proc = ctx.Process(target=_server_main, args=(spec, address),
                       daemon=True)
    proc.start()
    deadline = time.monotonic() + wait_for_socket_s
    while not os.path.exists(address):
        if proc.exitcode is not None:
            raise TransportError(
                f"engine server child died during startup "
                f"(exitcode {proc.exitcode})")
        if time.monotonic() > deadline:
            proc.terminate()
            raise TransportError(
                f"engine server gave no socket within "
                f"{wait_for_socket_s:.0f}s")
        time.sleep(0.05)
    return proc, address

__all__ = ["TransportError", "BundleSender", "RemoteEngineProxy",
           "EngineServer", "pipelined_migrate", "spawn_engine_server",
           "send_frame", "recv_frame", "recv_exact"]
