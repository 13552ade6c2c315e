"""The cross-process KV transport: the port's ``serving/transport.py``
against the JAX package's, on the CPU.

Each case of ``tests/unit/test_transport.py``, with its ``FakeEngine`` on a
thread behind a real AF_UNIX ``EngineServer``: the frame protocol, the
proxy's engine surface and typed errors, a flipped, truncated or torn
bundle refused by name with nothing adopted, the receiving side's
re-verification of a pulled bundle, and the bounded, seeded backoff
(asserted through an injected sleep, never waited out).  Then the wire
across the packages: a JAX ``RemoteEngineProxy`` drives a port
``EngineServer`` and a port proxy drives a JAX server, each reply of
``hello``, ``stats``, ``put``, ``step``, ``export``, ``import``, ``drain``
and the rest equal to what the same package's server gives (exact: the
decoded control frames, and the bundle frames byte for byte); a flipped
byte is refused by name on both sides.  Last, one real child spawned by
``spawn_engine_server`` on the CPU takes a migrated sequence and finishes
it to the uninterrupted stream (fp32 tiny llama, exact)."""

import json
import os
import socket
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import KVPageBundle as JaxBundle
from deepspeed_tpu.serving import kv_transfer as jkt
from deepspeed_tpu.serving import transport as jtr
from deepspeed_tpu.serving.admission import RejectedError as JaxRejectedError
from deepspeed_tpu.serving.config import TransportConfig as JaxTransportConfig
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceConfig, RaggedRequest
from deepspeed_tpu_torch.inference.v2.ragged import KVPageBundle
from deepspeed_tpu_torch.serving import kv_transfer as tkt
from deepspeed_tpu_torch.serving import transport as ttr
from deepspeed_tpu_torch.serving.admission import RejectedError
from deepspeed_tpu_torch.serving.config import TransportConfig
from deepspeed_tpu_torch.serving.kv_transfer import CorruptBundleError, bundle_to_bytes
from deepspeed_tpu_torch.serving.transport import (_FRAME_BUNDLE, _FRAME_JSON, BundleSender,
                                                   EngineServer, RemoteEngineProxy,
                                                   TransportError, recv_frame, send_frame)

torch.set_num_threads(2)

_META = dict(uid=7, tokens=list(range(10)), prompt_len=9, max_new_tokens=4, temperature=0.0,
             eos_id=None, prefilled=9, decode_entry=False, page_size=8,
             page_keys=[b"\x07" * 32], src_pages=[{"page": 1, "refcount": 1, "key": b"\x07" * 32}],
             model_sig=(1, 2, 2), kv_quant=False, dtype="fp32")


def _bundle(uid=7, pkg="port"):
    k = np.arange(1 * 1 * 8 * 2 * 2, dtype=np.float32).reshape(1, 1, 8, 2, 2)
    if pkg == "jax":
        return JaxBundle(**dict(_META, uid=uid, arrays={"k": k}))
    return KVPageBundle(**dict(_META, uid=uid, arrays={"k": torch.from_numpy(k)}))


class FakeEngine:
    """Pure-python engine surface for the dispatch table; records every
    mutating call so refusal tests can assert 'nothing adopted'.  ``pkg``
    picks the package whose bundle and RejectedError it speaks."""

    def __init__(self, pkg="port"):
        self.pkg = pkg
        self.block = SimpleNamespace(page_size=8)
        self.max_seq_len = 64
        self.allocator = SimpleNamespace(free_pages=40, num_pages=64)
        self.queue_depth = 2
        self.active_count = 1
        self.puts = []
        self.imported = []
        self.released = []
        self.closed = False
        self.reject_puts = False

    def has_work(self):
        return True

    def inflight_uids(self):
        return [11]

    def ready_uids(self):
        return [11]

    def put(self, request, *, record_shed=True):
        if self.reject_puts:
            err = JaxRejectedError if self.pkg == "jax" else RejectedError
            raise err("kv_pressure", retry_after_s=2.5, priority=request.priority)
        self.puts.append(request)
        return int(request.uid)

    def step(self):
        return {11: {"tokens": [3, 4], "done": False}}

    def export_sequence(self, uid):
        return _bundle(uid, self.pkg)

    def import_sequence(self, bundle):
        self.imported.append(bundle)
        return True

    def release_sequence(self, uid, reason="migrated"):
        self.released.append((uid, reason))

    def abort_all(self, reason="abort"):
        return [11]

    def drain(self, max_steps=10_000):
        fin = SimpleNamespace(uid=11, tokens=[3, 4, 5], prompt_len=9, finish_reason="eos")
        return {"finished": {11: fin}, "pending": []}

    def assert_no_leaks(self):
        pass

    def close(self):
        self.closed = True


def _serve(tmp_path, server_pkg="port", name="engine.sock"):
    address = str(tmp_path / name)
    engine = FakeEngine(server_pkg)
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(address)
    listener.listen(1)
    server = (EngineServer if server_pkg == "port" else jtr.EngineServer)(engine, listener)
    t = threading.Thread(target=server.serve, daemon=True)
    t.start()
    return engine, address, t


@pytest.fixture
def served(tmp_path):
    """A FakeEngine behind a real AF_UNIX EngineServer on a thread."""
    engine, address, t = _serve(tmp_path)
    yield engine, address
    t.join(timeout=5.0)
    assert not t.is_alive()  # every test closes its proxy: the server loop ended


def _fast_cfg(**kw):
    kw.setdefault("connect_retries", 5)
    kw.setdefault("backoff_base_s", 0.01)
    kw.setdefault("io_timeout_s", 5.0)
    return TransportConfig(**kw)


# ----------------------------- frame protocol -------------------------------
def test_frame_roundtrip_and_desync_refusal():
    a, b = socket.socketpair()
    try:
        send_frame(a, _FRAME_JSON, b'{"op":"x"}')
        send_frame(a, _FRAME_BUNDLE, b"\x00" * 1000)
        assert recv_frame(b) == (_FRAME_JSON, b'{"op":"x"}')
        assert recv_frame(b) == (_FRAME_BUNDLE, b"\x00" * 1000)
        a.sendall(b"Z" + (0).to_bytes(8, "little"))
        with pytest.raises(TransportError, match="frame kind"):
            recv_frame(b)
        a.sendall(_FRAME_JSON + (1 << 40).to_bytes(8, "little"))
        with pytest.raises(TransportError, match="frame length"):
            recv_frame(b)
    finally:
        a.close(), b.close()


def test_frames_identical_across_packages():
    """The same payload makes the same bytes on the socket in both
    packages, and each reads the other's frames."""
    for sender, receiver in ((ttr, jtr), (jtr, ttr)):
        a, b = socket.socketpair()
        try:
            sender.send_frame(a, sender._FRAME_JSON, b'{"op":"hello"}')
            sender.send_frame(a, sender._FRAME_BUNDLE, b"\x01\x02" * 300)
            raw = b.recv(1 << 16)
            while len(raw) < 2 * 9 + 14 + 600:
                raw += b.recv(1 << 16)
            assert raw == (b"J" + (14).to_bytes(8, "little") + b'{"op":"hello"}'
                           + b"B" + (600).to_bytes(8, "little") + b"\x01\x02" * 300)
            a.sendall(raw)
            assert receiver.recv_frame(b) == (b"J", b'{"op":"hello"}')
            assert receiver.recv_frame(b) == (b"B", b"\x01\x02" * 300)
        finally:
            a.close(), b.close()
    assert (ttr._MAX_FRAME, ttr._FRAME_JSON, ttr._FRAME_BUNDLE) == (
        jtr._MAX_FRAME, jtr._FRAME_JSON, jtr._FRAME_BUNDLE)


def test_peer_close_mid_frame_is_transport_error():
    a, b = socket.socketpair()
    a.sendall(_FRAME_BUNDLE + (100).to_bytes(8, "little") + b"x" * 10)
    a.close()
    try:
        with pytest.raises(TransportError, match="10/100 bytes"):
            recv_frame(b)
    finally:
        b.close()


# ----------------------------- proxy surface --------------------------------
def test_proxy_engine_surface_and_typed_errors(served):
    engine, address = served
    proxy = RemoteEngineProxy(address, _fast_cfg())
    assert proxy.block.page_size == 8 and proxy.max_seq_len == 64
    assert proxy.queue_depth == 2 and proxy.active_count == 1
    assert proxy.allocator.free_pages == 40
    assert proxy.allocator.num_pages == 64
    assert proxy.has_work() and proxy.inflight_uids() == [11]
    req = SimpleNamespace(prompt_ids=[1, 2, 3], max_new_tokens=4, temperature=0.0, eos_id=None,
                          uid=21, priority=1, deadline_s=None, trace_id="t-21")
    assert proxy.put(req) == 21
    assert engine.puts[0].prompt_ids == [1, 2, 3]
    assert engine.puts[0].trace_id == "t-21"
    out = proxy.step()
    assert out == {11: {"tokens": [3, 4], "done": False}}
    assert proxy.ready_uids() == [11]
    rt = proxy.export_sequence(11)
    assert rt.uid == 11 and torch.equal(rt.arrays["k"], _bundle().arrays["k"])
    proxy.release_sequence(11, reason="migrated")
    assert engine.released == [(11, "migrated")]
    assert proxy.abort_all() == [11]
    d = proxy.drain()
    assert d["finished"][11].tokens == [3, 4, 5]
    assert d["finished"][11].finish_reason == "eos"
    proxy.assert_no_leaks()
    engine.reject_puts = True
    with pytest.raises(RejectedError) as exc:
        proxy.put(req)
    assert exc.value.reason == "kv_pressure"
    assert exc.value.retry_after_s == 2.5
    proxy.close()
    assert engine.closed


# ----------------------------- wire hardening -------------------------------
def _import_raw(proxy, blob):
    reply, _ = proxy._sender.request({"op": "import"}, blob)
    return proxy._check(reply)


def test_bitflip_refused_naming_page_and_nothing_adopted(served):
    engine, address = served
    proxy = RemoteEngineProxy(address, _fast_cfg())
    wire = bundle_to_bytes(_bundle())
    flipped = bytearray(wire)
    flipped[-5] ^= 0xFF
    with pytest.raises(CorruptBundleError, match=r"page\(s\)"):
        _import_raw(proxy, bytes(flipped))
    assert engine.imported == []
    assert _import_raw(proxy, wire)["ok"] is True
    assert len(engine.imported) == 1
    proxy.close()


def test_truncated_and_torn_header_refused(served):
    engine, address = served
    proxy = RemoteEngineProxy(address, _fast_cfg())
    wire = bundle_to_bytes(_bundle())
    with pytest.raises(CorruptBundleError, match="truncated"):
        _import_raw(proxy, wire[:-7])
    with pytest.raises(CorruptBundleError, match="truncated"):
        _import_raw(proxy, wire[:20])
    with pytest.raises(CorruptBundleError):
        _import_raw(proxy, b"GARBAGE!" + wire[8:])
    assert engine.imported == []
    proxy.close()


def test_refused_bundle_counter_and_export_pull_verified(tmp_path):
    """The receiving side re-verifies whichever direction the bundle
    flows: a raw server replying to an export (pull) with a corrupted
    bundle frame is refused client-side, by name, and counted."""
    from deepspeed_tpu_torch.telemetry import get_registry

    address = str(tmp_path / "raw.sock")
    wire = bytearray(bundle_to_bytes(_bundle()))
    wire[-5] ^= 0xFF
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(address)
    listener.listen(1)

    def _raw_server():
        conn, _ = listener.accept()
        with conn:
            recv_frame(conn)  # hello
            send_frame(conn, _FRAME_JSON, json.dumps(
                {"page_size": 8, "max_seq_len": 64, "bundle_follows": False}).encode())
            recv_frame(conn)  # the export request
            send_frame(conn, _FRAME_JSON, json.dumps(
                {"ok": True, "bundle_follows": True}).encode())
            send_frame(conn, _FRAME_BUNDLE, bytes(wire))
        listener.close()

    t = threading.Thread(target=_raw_server, daemon=True)
    t.start()
    proxy = RemoteEngineProxy(address, _fast_cfg())
    try:
        with pytest.raises(CorruptBundleError, match=r"page\(s\)"):
            proxy.export_sequence(7)
    finally:
        proxy._sender.close()
        t.join(timeout=5.0)
    refused = get_registry().get("deepspeed_tpu_serving_transport_refused_bundles_total")
    assert refused is not None


# ----------------------------- bounded backoff ------------------------------
def test_backoff_is_bounded_seeded_and_exponential(tmp_path):
    """A dead peer costs exactly ``connect_retries`` attempts on the
    elastic-agent schedule, the same delays as the JAX sender's for the
    same seed."""
    import random as _random

    cfg = TransportConfig(connect_retries=5, backoff_base_s=0.05, backoff_max_s=2.0,
                          backoff_jitter=0.25)
    slept = []
    sender = BundleSender(str(tmp_path / "nobody.sock"), cfg, seed=7, sleep=slept.append)
    with pytest.raises(TransportError, match="5 bounded attempts"):
        sender.request({"op": "hello"})
    assert sender.connect_attempts == 5
    assert len(sender.backoffs_taken) == 4
    assert slept == sender.backoffs_taken
    r = _random.Random(7)
    expect = [min(0.05 * 2 ** (f - 1), 2.0) * (1 + 0.25 * r.random()) for f in range(1, 5)]
    assert sender.backoffs_taken == pytest.approx(expect, rel=0, abs=0)
    sender.close()
    jsender = jtr.BundleSender(str(tmp_path / "nobody.sock"),
                               JaxTransportConfig(connect_retries=5, backoff_base_s=0.05,
                                                  backoff_max_s=2.0, backoff_jitter=0.25),
                               seed=7, sleep=lambda _d: None)
    with pytest.raises(jtr.TransportError):
        jsender.request({"op": "hello"})
    assert jsender.backoffs_taken == sender.backoffs_taken
    jsender.close()


def test_sender_refuses_after_close(tmp_path):
    sender = BundleSender(str(tmp_path / "nobody.sock"), _fast_cfg(connect_retries=1),
                          sleep=lambda _d: None)
    sender.close()
    with pytest.raises(TransportError, match="closed"):
        sender.request({"op": "hello"})


# ----------------------------- the wire across packages ---------------------
_OPS = [({"op": "hello"}, None), ({"op": "stats"}, None),
        ({"op": "put", "record_shed": True, "request": {
            "prompt_ids": [1, 2, 3], "max_new_tokens": 4, "temperature": 0.0, "eos_id": None,
            "uid": 21, "priority": 1, "deadline_s": None, "trace_id": "t-21"}}, None),
        ({"op": "step"}, None), ({"op": "ready_uids"}, None), ({"op": "export", "uid": 11}, None),
        ({"op": "import"}, "bundle"), ({"op": "release", "uid": 11, "reason": "migrated"}, None),
        ({"op": "abort_all", "reason": "abort"}, None), ({"op": "drain", "max_steps": 8}, None),
        ({"op": "assert_no_leaks"}, None), ({"op": "no_such_op"}, None),
        ({"op": "import"}, "flipped"), ({"op": "shutdown"}, None)]


def _raw_session(address, sender_mod, cfg_cls):
    """Every op of ``_OPS`` through a sender of ``sender_mod``: the decoded
    replies and the bundle frames' bytes."""
    wire = bytearray(tkt.bundle_to_bytes(_bundle()))
    flipped = bytearray(wire)
    flipped[-5] ^= 0xFF
    payloads = {"bundle": bytes(wire), "flipped": bytes(flipped), None: None}
    sender = sender_mod.BundleSender(address, cfg_cls(connect_retries=3, backoff_base_s=0.01))
    try:
        return [sender.request(op, payloads[p]) for op, p in _OPS]
    finally:
        sender.close()


@pytest.fixture
def fixed_clock(monkeypatch):
    """Pin the wall-clock stamp (``sent_unix``): the only bytes of a record
    that depend on when it was written."""
    import time

    monkeypatch.setattr(time, "time", lambda: 1700000000.25)


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax")])
def test_one_package_drives_the_others_server(tmp_path, client, server, fixed_clock):
    """A sender of one package against a server of the other gives, op
    for op, the replies (exact) and bundle bytes (byte for byte) a server
    of the sender's own package gives; the flipped byte is refused by
    name on the serving side, the unknown op as a ValueError."""
    mods = {"port": (ttr, TransportConfig), "jax": (jtr, JaxTransportConfig)}
    engine, address, t = _serve(tmp_path, server, "cross.sock")
    got = _raw_session(address, *mods[client])
    t.join(timeout=5.0)
    own_engine, own_address, t2 = _serve(tmp_path, client, "own.sock")
    want = _raw_session(own_address, *mods[client])
    t2.join(timeout=5.0)
    assert not t.is_alive() and not t2.is_alive()
    assert got == want
    replies = dict(zip([op["op"] + str(i) for i, (op, _p) in enumerate(_OPS)], got))
    assert replies["hello0"][0] == {"page_size": 8, "max_seq_len": 64, "bundle_follows": False}
    assert replies["export5"][1] == tkt.bundle_to_bytes(_bundle(11))
    assert replies["no_such_op11"][0]["err"] == "value"
    refused = replies["import12"][0]
    assert refused["err"] == "corrupt" and "page(s)" in refused["msg"]
    assert engine.closed and len(engine.imported) == 1 and engine.released == [(11, "migrated")]


def test_refusal_texts_equal_jax():
    """#F13: a corrupt import's refusal crosses the wire as its message, so
    the page-CRC and trace-block refusals read as the JAX package's, word
    for word (they differed in punctuation)."""
    for trace in (None, {"trace_id": "r1-9", "hops": []}):
        wire = bytearray(jkt.bundle_to_bytes(JaxBundle(**dict(
            _META, arrays={"k": np.arange(32, dtype=np.float32).reshape(1, 1, 8, 2, 2)},
            trace=trace))))
        if trace is None:
            wire[-5] ^= 0xFF
        else:
            off = len(jkt._MAGIC)
            hlen = int.from_bytes(wire[off:off + 8], "little")
            header = json.loads(bytes(wire[off + 8:off + 8 + hlen]).decode())
            header["trace"]["trace_id"] = "r1-FORGED"
            hdr = json.dumps(header).encode()
            wire = jkt._MAGIC + len(hdr).to_bytes(8, "little") + hdr + bytes(
                wire[off + 8 + hlen:])
        with pytest.raises(jkt.CorruptBundleError) as want:
            jkt.bundle_from_bytes(bytes(wire))
        with pytest.raises(CorruptBundleError) as got:
            tkt.bundle_from_bytes(bytes(wire))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("client", ["jax", "port"])
def test_proxies_drive_the_other_package(tmp_path, client):
    """The engine-shaped proxies across the packages: put, step, export
    (the bundle read by the proxy's own package), import and drain."""
    server = "port" if client == "jax" else "jax"
    engine, address, t = _serve(tmp_path, server)
    mod, cfg = (jtr, JaxTransportConfig) if client == "jax" else (ttr, TransportConfig)
    proxy = mod.RemoteEngineProxy(address, cfg(connect_retries=3, backoff_base_s=0.01))
    req = SimpleNamespace(prompt_ids=[5, 6], max_new_tokens=3, temperature=0.0, eos_id=None,
                          uid=4, priority=1, deadline_s=2.0, trace_id="t-4")
    assert proxy.put(req) == 4 and engine.puts[0].deadline_s == 2.0
    assert proxy.step() == {11: {"tokens": [3, 4], "done": False}}
    rt = proxy.export_sequence(11)
    assert rt.uid == 11 and np.array_equal(np.asarray(rt.arrays["k"]),
                                           np.asarray(_bundle(pkg="jax").arrays["k"]))
    assert proxy.import_sequence(rt) and engine.imported[0].uid == 11
    assert proxy.drain()["finished"][11].tokens == [3, 4, 5]
    proxy.close()
    t.join(timeout=5.0)
    assert engine.closed and not t.is_alive()


# ----------------------------- a real child on the CPU ----------------------
def test_spawned_child_takes_a_migrated_sequence(tmp_path):
    """``spawn_engine_server`` with ``device="cpu"``: the child draws the
    spec's seeded weights itself (the same as ``fleet_params`` here), takes
    a sequence migrated mid-decode through ``pipelined_migrate``, and
    finishes it to the uninterrupted stream (exact).  Its report: no kernel
    compiled, no JAX module loaded, its prefill and decode launches
    counted by its own wrappers (0 on the CPU)."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models.llama import llama_model
    from deepspeed_tpu_torch.serving.router import fleet_params

    cfg = dict(dtype="fp32", page_size=8, num_pages=32, max_seqs=2, max_pages_per_seq=8)
    model = llama_model("tiny", max_seq_len=64)
    params = fleet_params(model, None, torch.float32, "cpu", seed=3)
    report = str(tmp_path / "child.json")
    proc, address = ttr.spawn_engine_server(
        {"model": "tiny", "seed": 3, "max_seq_len": 64, "device": "cpu",
         "engine_config": RaggedInferenceConfig(**cfg), "report_path": report},
        address=os.path.join(str(tmp_path), "c.sock"))
    try:
        prompt = [int(x) for x in np.random.RandomState(9).randint(0, 256, 13)]
        want = InferenceEngineV2(model, RaggedInferenceConfig(**cfg), params=params,
                                 device="cpu").generate_all(
            [RaggedRequest(prompt_ids=prompt, max_new_tokens=6)])[0]
        src = InferenceEngineV2(model, RaggedInferenceConfig(**cfg), params=params, device="cpu")
        uid = src.put(RaggedRequest(prompt_ids=prompt, max_new_tokens=6))
        toks = []
        while uid not in src.ready_uids():
            toks += src.step().get(uid, {}).get("tokens", [])
        proxy = RemoteEngineProxy(address, _fast_cfg())
        assert ttr.pipelined_migrate(src, proxy, [uid]) == 1
        assert not src.has_work()
        while proxy.has_work():
            toks += proxy.step().get(uid, {}).get("tokens", [])
        assert toks == want
        proxy.assert_no_leaks()
        proxy.close()
        proc.join(timeout=30)
        assert proc.exitcode == 0
        with open(report) as f:
            rep = json.load(f)
        assert rep["compiled"] == [] and rep["device"] == "cpu"
        assert rep["launches"] == {"flash_attention_fwd": 0, "paged_decode_attention": 0}
        assert "jax" not in rep["packages"] and "deepspeed_tpu" not in rep["packages"]
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=10)


def test_a_child_that_fails_to_start_raises(tmp_path):
    """No fallback: a child whose engine build fails exits non-zero and
    ``spawn_engine_server`` raises."""
    with pytest.raises(TransportError, match="died during startup"):
        ttr.spawn_engine_server({"model": "no_such_size", "device": "cpu"},
                                address=os.path.join(str(tmp_path), "d.sock"),
                                wait_for_socket_s=120)
