"""The port's wire framing against the JAX package's: the same message
makes the same frame bytes in both, and each package's ``recv_msg``
decodes the other's frames (dense, packed 2-bit and large arrays, control
messages and a snapshot tree; with and without a secret; out-of-band and
in-band framing)."""

import socket
import threading

import numpy as np
import pytest

from dt_tpu.elastic import protocol as jproto
from dt_tpu_torch.elastic import protocol as tproto
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)


class _Capture:
    """A socket stand-in whose ``sendmsg`` records the bytes."""

    def __init__(self):
        self.data = bytearray()

    def sendmsg(self, segs):
        n = 0
        for s in segs:
            self.data += bytes(s)
            n += memoryview(s).nbytes
        return n


def _frame(mod, msg) -> bytes:
    cap = _Capture()
    mod.send_msg(cap, msg)
    return bytes(cap.data)


def _recv(mod, frame: bytes):
    """``mod.recv_msg`` over a real socket pair fed ``frame``."""
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=a.sendall, args=(frame,))
        t.start()
        out = mod.recv_msg(b)
        t.join(10)
        return out
    finally:
        a.close()
        b.close()


def _same(x, y) -> bool:
    if isinstance(x, dict):
        return isinstance(y, dict) and x.keys() == y.keys() and \
            all(_same(x[k], y[k]) for k in x)
    if isinstance(x, np.ndarray):
        return isinstance(y, np.ndarray) and x.dtype == y.dtype and \
            x.shape == y.shape and x.tobytes() == y.tobytes()
    return type(x) is type(y) and x == y


def _messages():
    rng = np.random.RandomState(0)
    n = 10_007
    words = rng.randint(0, 2 ** 32, -(-n // 16), dtype=np.uint64) \
        .astype(np.uint32)
    return {
        "control": {"cmd": "mc_barrier", "host": "w1", "epoch": 3,
                    "info": {"EPOCH_BEGIN": 3}},
        "dense": {"cmd": "allreduce", "host": "w0", "key": "grads#b2",
                  "seq": 7, "value": rng.normal(size=n).astype(np.float32)},
        "packed": {"cmd": "allreduce", "host": "w0", "key": "grads#c0",
                   "seq": 0, "value": {"packed": words, "n": n,
                                       "threshold": 0.005}},
        "large": {"cmd": "allreduce", "host": "w2", "key": "stats",
                  "seq": 1,
                  "value": rng.normal(size=1 << 20).astype(np.float32)},
        "snapshot": {"cmd": "publish_snapshot", "blob": {
            "step": np.asarray(12, np.int32),
            "params": {"Conv_0": {"kernel": rng.normal(
                size=(3, 3, 3, 8)).astype(np.float32)},
                "Dense_0": {"bias": np.zeros(2, np.float32)}},
            "opt_state": {"count": np.asarray(12, np.int32)}}},
        "tiny_array": {"value": np.arange(5, dtype=np.float32)},
    }


@pytest.mark.parametrize("inband", ["", "1"])
@pytest.mark.parametrize("secret", [None, "s3cret"])
@pytest.mark.parametrize("kind", sorted(_messages()))
def test_frames_are_byte_identical_and_cross_decode(monkeypatch, kind,
                                                    secret, inband):
    """The port's frame equals the JAX package's and each package decodes
    it; with ``inband`` the JAX package sends its copying framing
    (``DT_WIRE_INBAND=1``, every buffer in-band), which the port's
    ``recv_msg`` decodes as well."""
    if secret:
        monkeypatch.setenv("DT_ELASTIC_SECRET", secret)
    else:
        monkeypatch.delenv("DT_ELASTIC_SECRET", raising=False)
    msg = _messages()[kind]
    port_frame = _frame(tproto, msg)
    monkeypatch.setenv("DT_WIRE_INBAND", inband)
    ref_frame = _frame(jproto, msg)
    if not inband:
        assert port_frame == ref_frame
    assert _same(msg, _recv(jproto, port_frame))
    assert _same(msg, _recv(tproto, port_frame))
    assert _same(msg, _recv(tproto, ref_frame))


def test_mixed_auth_fails_loudly(monkeypatch):
    """A frame without the secret is refused by a receiver that has it,
    in both directions between the packages."""
    msg = _messages()["control"]
    monkeypatch.delenv("DT_ELASTIC_SECRET", raising=False)
    plain = _frame(tproto, msg)
    monkeypatch.setenv("DT_ELASTIC_SECRET", "k")
    with pytest.raises(IOError, match="unauthenticated"):
        _recv(jproto, plain)
    monkeypatch.setenv("DT_ELASTIC_SECRET", "other")
    signed = _frame(jproto, msg)
    monkeypatch.setenv("DT_ELASTIC_SECRET", "k")
    with pytest.raises(IOError, match="HMAC"):
        _recv(tproto, signed)


def test_token_cache_and_backoff_match():
    """``TokenCache`` TTL/LRU and the decorrelated-jitter backoff draw the
    same as the JAX package's."""
    import random
    now = [0.0]
    caches = [m.TokenCache(cap=3, ttl_s=10.0, clock=lambda: now[0])
              for m in (jproto, tproto)]
    for c in caches:
        for i in range(5):
            c.put(f"t{i}", {"i": i})
    now[0] = 5.0
    assert [[c.get(f"t{i}") for i in range(5)] for c in caches][0] == \
        [[c.get(f"t{i}") for i in range(5)] for c in caches][1]
    now[0] = 20.0
    assert caches[0].get("t4") is None and caches[1].get("t4") is None
    for delay in (0.2, 1.0, 4.0):
        assert jproto.next_backoff(delay, 0.2, 5.0, rng=random.Random(3)) \
            == tproto.next_backoff(delay, 0.2, 5.0, rng=random.Random(3))
