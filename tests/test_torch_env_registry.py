"""The port's environment registry against the JAX package's.

``DT_SERVER_ID`` (a range server's index under the launcher's contract) and
``DT_DECODE_THREADS`` (the decode pool of ``ImageRecordIter``) have rows
with the JAX package's defaults and docs, and the port reads them through
``config.env``; every ``DT_*`` name a port source reads has a row, so no
read raises ``KeyError``.
"""

import re
from pathlib import Path

import pytest

from dt_tpu import config as jconfig
from dt_tpu_torch import config as tconfig
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

PORT = Path(__file__).resolve().parents[1] / "dt_tpu_torch"


@pytest.mark.parametrize("name", ["DT_SERVER_ID", "DT_DECODE_THREADS"])
def test_rows_are_the_jax_package_s(name, monkeypatch):
    assert tconfig.ENV_REGISTRY[name] == jconfig.ENV_REGISTRY[name]
    monkeypatch.delenv(name, raising=False)
    assert tconfig.env(name) == jconfig.ENV_REGISTRY[name][0]
    monkeypatch.setenv(name, "3")
    assert tconfig.env(name) == "3"


def test_range_server_takes_its_index_from_the_registry(monkeypatch):
    from dt_tpu_torch.elastic import range_server

    seen = {}

    class Stop(Exception):
        pass

    def fake(host, sched_port, index, **kw):
        seen["index"] = index
        raise Stop

    monkeypatch.setattr(range_server, "RangeServer", fake)
    monkeypatch.setenv("DT_SERVER_ID", "5")
    with pytest.raises(Stop):
        range_server.main(["--scheduler-port", "1"])
    assert seen["index"] == 5


def test_decode_threads_sizes_the_pool(tmp_path, monkeypatch):
    from dt_tpu_torch import data
    path = str(tmp_path / "r.rec")
    with data.RecordIOWriter(path) as w:
        w.write(data.pack_label(bytes(12), 1))
    monkeypatch.setenv("DT_DECODE_THREADS", "3")
    it = data.ImageRecordIter(path, (2, 2, 3), 1)
    assert it._pool._max_workers == 3
    it.close()
    monkeypatch.setenv("DT_DECODE_THREADS", "1")
    assert data.ImageRecordIter(path, (2, 2, 3), 1)._pool is None


def test_every_port_read_has_a_row():
    reads = set()
    pat = re.compile(r"(?:environ(?:\.get)?[\[(]|\benv(?:_flag)?\()"
                     r"\"(DT_[A-Z0-9_]+)\"")
    for f in PORT.rglob("*.py"):
        reads |= set(pat.findall(f.read_text()))
    assert {"DT_SERVER_ID", "DT_DECODE_THREADS", "DT_OBS"} <= reads
    assert sorted(reads - set(tconfig.ENV_REGISTRY)) == []
