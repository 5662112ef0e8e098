"""The port's profiler (``utils/profiler.py`` on ``torch.profiler``)
against the JAX package's surface (``dt_tpu/utils/profiler.py``).

- The same public names; ``set_config``/``set_state``/``dump`` write a
  chrome trace of the session into the configured directory, rank
  prefixed under a remote command, and ``annotate`` names a region of it.
- A second session while one runs raises (one profiler a process).
- Remote control through either package's scheduler: a port worker's
  ``profile_command`` applies on itself at once, and a peer's heartbeat
  reply carries the same commands as the JAX scheduler's.
"""

import json
import os

import pytest
import torch

from dt_tpu.elastic import Scheduler as JScheduler
from dt_tpu.elastic import protocol as jproto
from dt_tpu.utils import profiler as jprof
from dt_tpu_torch.elastic.client import WorkerClient as TClient
from dt_tpu_torch.elastic.scheduler import Scheduler as TScheduler
from dt_tpu_torch.utils import profiler as tprof
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture(autouse=True)
def _stopped():
    yield
    tprof.set_state("stop")
    tprof.set_config()


def test_the_surface_is_the_jax_packages():
    names = ("set_config", "set_state", "pause", "resume", "dump", "trace",
             "annotate", "apply_remote", "set_config_all", "set_state_all",
             "dump_all")
    for n in names:
        assert callable(getattr(tprof, n)) and callable(getattr(jprof, n))
    with pytest.raises(ValueError):
        tprof.set_state("go")
    with pytest.raises(ValueError):
        tprof.apply_remote("explode", {}, rank=0)


def test_a_session_writes_its_trace(tmp_path):
    out = str(tmp_path / "prof")
    tprof.set_config(filename=out)
    tprof.set_state("run")
    assert tprof.running()
    with pytest.raises(RuntimeError, match="already running"):
        tprof._start()
    with tprof.annotate("my_region"):
        torch.ones(16).mul(2).sum()
    assert tprof.dump() == out and not tprof.running()
    events = json.load(open(os.path.join(out, "trace.json")))["traceEvents"]
    assert any(e.get("name") == "my_region" for e in events)
    # a remote command writes under the rank prefix; pause/resume cycle
    tprof.apply_remote("set_config", {"filename": out}, rank=3)
    tprof.apply_remote("set_state", {"state": "run"}, rank=3)
    tprof.pause()
    assert not tprof.running()
    assert os.path.exists(os.path.join(str(tmp_path), "rank3_prof",
                                       "trace.json"))
    with tprof.trace(str(tmp_path / "ctx")):
        torch.zeros(4).add(1)
    assert os.path.exists(str(tmp_path / "ctx" / "trace.json"))


def test_remote_commands_ride_either_scheduler(tmp_path):
    replies = []
    for cls in (TScheduler, JScheduler):
        sched = cls(initial_workers=["w0", "w1"])
        try:
            c = TClient("127.0.0.1", sched.port, host="w0",
                        heartbeat_interval_s=3600)
            jproto.request("127.0.0.1", sched.port,
                           {"cmd": "register", "host": "w1"}, timeout=10)
            out = str(tmp_path / "p")
            s1 = c.profile_command("set_config", {"filename": out})
            s2 = c.profile_command("set_state", {"state": "run"})
            assert tprof.running()
            s3 = c.profile_command("dump")
            assert not tprof.running() and (s1, s2, s3) == (1, 2, 3)
            assert os.path.exists(os.path.join(
                os.path.dirname(out), "rank0_p", "trace.json"))
            replies.append(jproto.request(
                "127.0.0.1", sched.port,
                {"cmd": "heartbeat", "host": "w1", "pseq": 0}, timeout=10))
            c.close()
        finally:
            sched.close()
    assert replies[0] == replies[1]
    assert [c["action"] for c in replies[0]["profile_cmds"]] == [
        "set_config", "set_state", "dump"]
