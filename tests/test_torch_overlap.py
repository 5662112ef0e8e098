"""The port's overlap engine against the JAX package's grid and the serial
step: ``bucket_bounds`` equals the JAX package's, the staging pool
recycles, and ``GradSyncEngine.sync`` returns the serial allreduce's bits,
dense and 2-bit, with two port clients against the JAX ``Scheduler``."""

import threading

import numpy as np
import pytest
import torch

from dt_tpu.elastic import Scheduler as JScheduler
from dt_tpu.training import overlap as joverlap
from dt_tpu_torch.elastic.client import WorkerClient
from dt_tpu_torch.parallel.compression import GradientCompression
from dt_tpu_torch.training import overlap as toverlap


@pytest.mark.parametrize("quantum", [1, 16])
def test_bucket_bounds_match(quantum):
    grid = [(n, e, b) for n in (0, 1, 15, 16, 17, 1000, 4096)
            for e in (2, 4) for b in (1, 7, 64, 4096, 4 << 20)]
    grid += [(25_557_032, 4, 4 << 20), (25_557_032, 4, 1 << 20)]
    for n, elem_bytes, bucket in grid:
        assert toverlap.bucket_bounds(n, elem_bytes, bucket, quantum) == \
            joverlap.bucket_bounds(n, elem_bytes, bucket, quantum)


def test_staging_pool_acquire_release_forfeit():
    pool = toverlap.StagingPool(max_bytes=64)
    a = pool.acquire(8, torch.float32)
    b = pool.acquire(8, torch.float32)
    assert pool.outstanding == 2 and pool.allocated == 2
    pool.release(a)
    assert pool.acquire(8, torch.float32) is a  # recycled
    pool.forfeit(b)  # dropped, never handed out again
    c = pool.acquire(8, torch.float32)
    assert c is not b and pool.allocated == 3
    big = pool.acquire(32, torch.float32)  # 128 bytes: past the cap
    pool.release(big)
    assert pool.acquire(32, torch.float32) is not big
    assert toverlap.host_view(pool.acquire(4, torch.int32)).dtype == \
        np.uint32


def _grads(rank, n, step):
    rng = np.random.RandomState(100 * rank + step)
    g = rng.normal(0, 0.01, n).astype(np.float32)
    g[rng.randint(0, n, 5)] = 0.02  # some codes past the threshold
    return torch.from_numpy(g), torch.from_numpy(
        rng.normal(size=37).astype(np.float32))


@pytest.mark.parametrize("compress", [None, 0.005])
def test_overlap_is_bit_identical_to_serial(monkeypatch, compress):
    """Two port clients in threads, three steps each way: the serial
    allreduce of the whole vector (chunked at 8 KiB) and the engine's
    buckets (4 KiB, window 2) give the same averages, bit for bit."""
    monkeypatch.setenv("DT_AR_BUCKET_BYTES", "4096")
    monkeypatch.setenv("DT_AR_CHUNK_BYTES", "8192")
    monkeypatch.setenv("DT_AR_STAGING_MB", "1")
    n = 10_007
    sched = JScheduler(initial_workers=["a", "b"])
    clients = {}
    try:
        for h in ("a", "b"):
            clients[h] = WorkerClient("127.0.0.1", sched.port, host=h,
                                      heartbeat_interval_s=5.0)
        out = {}

        def worker(rank, h):
            c = clients[h]
            gcs = [GradientCompression(compress) if compress else None
                   for _ in range(2)]
            eng = toverlap.GradSyncEngine(torch.device("cpu"))
            res, allocated = [], []
            for step in range(3):
                g, s = _grads(rank, n, step)
                if gcs[0] is not None:
                    words = gcs[0].compress_on_device(g)
                    payload = {"packed": words.numpy().view(np.uint32),
                               "n": n, "threshold": compress}
                else:
                    payload = g.numpy()
                serial = (c.allreduce("grads", payload),
                          c.allreduce("stats", s.numpy()))
                avg, avg_s = eng.sync(c, gcs[1], g, s)
                res.append((serial, (avg.numpy(), avg_s)))
                allocated.append(eng.staging.allocated)
            out[h] = (res, eng.staging.outstanding, allocated)

        ts = [threading.Thread(target=worker, args=(i, h))
              for i, h in enumerate(("a", "b"))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        assert not any(t.is_alive() for t in ts)
    finally:
        for c in clients.values():
            c.close()
        sched.close()
    for h in ("a", "b"):
        res, outstanding, allocated = out[h]
        assert outstanding == 0
        # a step takes one buffer a bucket and one for the stats; over
        # three steps the pool never holds more than one step's worth
        per_step = len(toverlap.bucket_bounds(n, 4, 4096,
                                              16 if compress else 1)) + 1
        assert 0 < allocated[0] <= allocated[-1] <= per_step
        for (sg, ss), (og, os_) in res:
            assert og.dtype == np.float32 and og.shape == (n,)
            assert og.tobytes() == np.asarray(sg).tobytes()
            assert os_.tobytes() == np.asarray(ss).tobytes()
    # both workers hold the same averages
    for (sa, oa), (sb, ob) in zip(out["a"][0], out["b"][0]):
        assert oa[0].tobytes() == ob[0].tobytes()


def test_enabled_follows_the_escape_hatch(monkeypatch):
    class Ctrl:
        def allreduce_pipeline(self, key, window=None):
            raise AssertionError

    assert toverlap.enabled(Ctrl())
    assert not toverlap.enabled(object())
    monkeypatch.setenv("DT_AR_OVERLAP", "0")
    assert not toverlap.enabled(Ctrl())
