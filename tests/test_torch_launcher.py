"""The port's launcher (``dt_tpu_torch.launcher``), as ``tests/
test_launcher.py`` and ``tests/test_launcher_ssh.py`` hold the JAX
package's: the local launcher starts the port's scheduler here and the
workers (and range servers, and a warm standby) as processes wired by the
env contract, with a per-job secret that never enters ``os.environ``; the
ssh launcher does the same through an injected fake ssh that runs the
remote command under a scrubbed environment.  Plus a ``--standby``
launch, an elastic add that starts the joiner with ``NEW_WORKER`` and
``EPOCH_BEGIN``, and the port's worker harness under the launcher's
command line with the policy engine on.  The trainees import only the
port."""

import json
import os
import stat
import subprocess
import sys
import textwrap

import pytest

import torch_elastic_job as job
from dt_tpu_torch.elastic import protocol
from dt_tpu_torch.launcher import launch_local, launch_ssh, main
from torch_one_thread import ENV, one_torch_thread  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _deadline():
    with job.deadline(120):
        yield


def _trainee(tmp_path, body, name="trainee.py"):
    script = tmp_path / name
    script.write_text(textwrap.dedent(f"""
        import os, sys
        sys.path.insert(0, {REPO!r})
        from dt_tpu_torch.elastic.client import auto_client
        c = auto_client()
        assert c is not None, "env contract missing"
        me = os.environ["DT_WORKER_ID"]
        out = {str(tmp_path)!r}
    """) + textwrap.dedent(body) + "\nc.close()\n")
    return str(script)


def test_launch_local_runs_workers(tmp_path):
    script = _trainee(tmp_path, """
        assert os.environ["ELASTIC_TRAINING_ENABLED"] == "1"
        c.barrier()
        open(os.path.join(out, me + ".ok"), "w").write(
            f"{c.rank}/{c.num_workers}")
    """)
    rcs = launch_local(2, [sys.executable, script], elastic=True)
    assert rcs == {"worker-0": 0, "worker-1": 0}
    got = sorted(open(str(tmp_path / f"worker-{i}.ok")).read()
                 for i in range(2))
    assert got == ["0/2", "1/2"]


def test_launch_local_with_range_servers(tmp_path):
    """``num_servers`` starts the port's range servers before the workers;
    they see the fleet at registration and a round shards across it."""
    script = _trainee(tmp_path, """
        import numpy as np
        assert len(c.servers) == 2, f"expected 2 servers, got {c.servers}"
        got = c.allreduce("g", np.full(4, float(c.rank), np.float32))
        np.testing.assert_allclose(got, np.full(4, 0.5, np.float32))
        open(os.path.join(out, me + ".ok"), "w").write("ok")
    """)
    rcs = launch_local(2, [sys.executable, script], elastic=True,
                       num_servers=2)
    assert all(rc == 0 for rc in rcs.values()), rcs
    for i in range(2):
        assert (tmp_path / f"worker-{i}.ok").exists()


def test_launch_local_authenticated_by_default(tmp_path, monkeypatch):
    """A generated per-job secret reaches the workers' env, frames are
    HMAC-checked (a peer without the secret is refused), and the secret
    stays out of the launcher's own env and override after the job."""
    monkeypatch.delenv("DT_ELASTIC_SECRET", raising=False)
    monkeypatch.delenv("DT_ELASTIC_INSECURE", raising=False)
    script = _trainee(tmp_path, """
        from dt_tpu_torch.elastic import protocol
        secret = os.environ.get("DT_ELASTIC_SECRET", "")
        assert len(secret) >= 32, "launcher did not propagate a secret"
        c.barrier()
        os.environ["DT_ELASTIC_SECRET"] = ""
        try:
            protocol.request("127.0.0.1",
                             int(os.environ["DMLC_PS_ROOT_PORT"]),
                             {"cmd": "membership"}, timeout=10.0)
            raise SystemExit("an unauthenticated frame was accepted")
        except (IOError, ConnectionError):
            pass
        os.environ["DT_ELASTIC_SECRET"] = secret
        open(os.path.join(out, me + ".sec"), "w").write(secret)
    """)
    rcs = launch_local(2, [sys.executable, script], elastic=True)
    assert all(rc == 0 for rc in rcs.values()), rcs
    seen = {open(str(tmp_path / f"worker-{i}.sec")).read()
            for i in range(2)}
    assert len(seen) == 1
    assert "DT_ELASTIC_SECRET" not in os.environ
    assert protocol._SECRET_OVERRIDE is None


def test_launch_local_insecure_opt_out(tmp_path, monkeypatch):
    monkeypatch.delenv("DT_ELASTIC_SECRET", raising=False)
    monkeypatch.setenv("DT_ELASTIC_INSECURE", "1")
    script = _trainee(tmp_path, """
        assert not os.environ.get("DT_ELASTIC_SECRET")
        c.barrier()
    """)
    assert launch_local(1, [sys.executable, script], elastic=True) == \
        {"worker-0": 0}


def test_launch_local_standby(tmp_path):
    """``--standby``: the journal and lease in ``ha_dir``, a warm-standby
    ``scheduler_main`` process, both endpoints in every worker's
    ``DT_CTRL_ENDPOINTS`` (the primary first), the standby answering
    ``not_leader`` while the primary leads; the standby is stopped when
    the job ends."""
    had = tmp_path / "ha"
    script = _trainee(tmp_path, """
        from dt_tpu_torch.elastic import protocol
        eps = os.environ["DT_CTRL_ENDPOINTS"].split(",")
        assert len(eps) == 2
        assert eps[0].endswith(":" + os.environ["DMLC_PS_ROOT_PORT"])
        host, port = eps[1].split(":")
        r = protocol.request(host, int(port), {"cmd": "membership"},
                             timeout=10)
        assert r.get("error") == "not_leader", r
        st = protocol.request(host, int(port), {"cmd": "status"},
                              timeout=10)
        assert st["active"] is False
        c.barrier()
        open(os.path.join(out, me + ".ok"), "w").write(
            f"{c.fence}")
    """)
    rcs = launch_local(2, [sys.executable, script], elastic=True,
                       standby=True, ha_dir=str(had))
    assert all(rc == 0 for rc in rcs.values()), rcs
    assert {open(str(tmp_path / f"worker-{i}.ok")).read()
            for i in range(2)} == {"1"}
    assert (had / "ctrl.journal").stat().st_size > 0
    assert (had / "ctrl.lease").exists() and (had / "standby.port").exists()
    port = int((had / "standby.port").read_text())
    with pytest.raises(OSError):
        protocol.request("127.0.0.1", port, {"cmd": "status"}, timeout=2,
                         retries=0)


def test_launch_local_elastic_add_starts_the_joiner(tmp_path):
    """A host added to host_worker mid-job is started by the launch
    callback with the same command, ``NEW_WORKER=1`` and
    ``EPOCH_BEGIN`` of the barrier that admitted it."""
    hw = tmp_path / "host_worker"
    hw.write_text("alpha\nbeta\n")
    script = _trainee(tmp_path, f"""
        begin = int(os.environ.get("EPOCH_BEGIN", "0"))
        for epoch in range(begin, 4):
            if me == "alpha" and epoch == 2:
                tmp = {str(hw)!r} + ".tmp"
                open(tmp, "w").write("alpha\\nbeta\\ngamma\\n")
                os.replace(tmp, {str(hw)!r})
            c.membership_change_barrier({{"EPOCH_BEGIN": epoch}})
        env = {{k: os.environ.get(k) for k in (
            "NEW_WORKER", "EPOCH_BEGIN", "TRAINING_CMD")}}
        env["members"] = f"{{c.rank}}/{{c.num_workers}}"
        import json
        json.dump(env, open(os.path.join(out, me + ".json"), "w"))
    """)
    cmd = [sys.executable, script]
    rcs = launch_local(2, cmd, hostfile=str(hw), elastic=True)
    assert rcs == {"alpha": 0, "beta": 0, "gamma": 0}
    got = {h: json.load(open(str(tmp_path / f"{h}.json")))
           for h in rcs}
    assert got["gamma"] == {"NEW_WORKER": "1", "EPOCH_BEGIN": "2",
                            "TRAINING_CMD": " ".join(cmd),
                            "members": "2/3"}
    assert got["alpha"]["NEW_WORKER"] is None
    assert got["alpha"]["members"] == "0/3"


def test_main_cli_exit_codes(tmp_path):
    ok = _trainee(tmp_path, "c.barrier()\n", "ok.py")
    bad = _trainee(tmp_path, "raise SystemExit(3)\n", "bad.py")
    assert main(["-n", "2", "--elastic-training-enabled", "True", "--",
                 sys.executable, ok]) == 0
    assert main(["-n", "1", "--", sys.executable, bad]) == 1
    with pytest.raises(SystemExit):
        main(["-n", "1", "--launcher", "ssh", "--standby", "-H", ok, "--",
              "true"])


def test_port_worker_harness_under_the_launcher(tmp_path):
    """The command line the card drill uses, on the CPU at tinybn size:
    ``python -m dt_tpu_torch.launcher.launch -n 2 -H hw --standby
    --elastic-training-enabled True -- <port worker>``, the policy engine
    on (out of reach, so equal shares): every worker exits 0, the launcher
    returns 0, every epoch's sha256 agrees, the batches are the shares'
    and the journal holds the decisions."""
    hw = tmp_path / "host_worker"
    hw.write_text("w0\nw2\n")
    env = dict(os.environ, DT_POLICY="1", DT_POLICY_STRAGGLER_MS="1e9",
               PYTHONPATH=REPO, **ENV)
    env.pop("XLA_FLAGS", None)
    had = tmp_path / "ha"
    out = str(tmp_path / "{host}.json")
    proc = subprocess.run(
        [sys.executable, "-m", "dt_tpu_torch.launcher.launch", "-n", "2",
         "-H", str(hw), "--standby", "--ha-dir", str(had),
         "--elastic-training-enabled", "True", "--",
         sys.executable, job.PORT_WORKER, "--device", "cpu",
         "--num-epoch", "2", "--out", out],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=110)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = {h: job.load(str(tmp_path / f"{h}.json")) for h in ("w0", "w2")}
    for e0, e2 in zip(r["w0"]["epochs"], r["w2"]["epochs"]):
        assert e0["sha256"] == e2["sha256"]
        assert (e0["batch"], e2["batch"]) == (16, 16)
        assert e0["grad_scale"] == e2["grad_scale"] == 1.0
    from dt_tpu_torch.elastic import journal
    st = journal.ControlState.rebuild(str(had / "ctrl.journal"))
    assert [e["shares"] for e in st.policy_log] == [{"w0": 5000,
                                                     "w2": 5000}]


# -- the ssh launcher, through a fake ssh ---------------------------------


def _fake_ssh(tmp_path, log_argv=False):
    """``fake_ssh <host> <remote command>``: logs the host (or the whole
    argv) and runs the remote command here under a scrubbed environment,
    as a fresh ssh session would."""
    shim = tmp_path / ("fake_ssh_argv" if log_argv else "fake_ssh")
    log = (f'printf \'%s\\n\' "$@" >> {tmp_path}/ssh_argv.log'
           if log_argv else f'echo "$host" >> {tmp_path}/ssh_dials.log')
    shim.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        host="$1"; shift
        {log}
        exec env -i PATH="$PATH" HOME="$HOME" sh -c "$1"
    """))
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    return str(shim)


def test_launch_ssh_runs_workers_via_shim(tmp_path):
    hostfile = tmp_path / "host_worker"
    hostfile.write_text("alpha\nbeta\n")
    script = _trainee(tmp_path, """
        c.barrier()
        open(os.path.join(out, me + ".ok"), "w").write(
            f"{c.rank}/{c.num_workers}")
    """)
    rcs = launch_ssh(2, [sys.executable, script], str(hostfile),
                     elastic=True, ssh_cmd=_fake_ssh(tmp_path),
                     root_uri="127.0.0.1", workdir=str(tmp_path))
    assert rcs == {"alpha": 0, "beta": 0}
    got = sorted(open(str(tmp_path / f"{h}.ok")).read()
                 for h in ("alpha", "beta"))
    assert got == ["0/2", "1/2"]
    dialed = open(str(tmp_path / "ssh_dials.log")).read().split()
    assert sorted(dialed) == ["alpha", "beta"]


def test_launch_ssh_env_contract_without_inheritance(tmp_path,
                                                     monkeypatch):
    hostfile = tmp_path / "host_worker"
    hostfile.write_text("solo\n")
    script = _trainee(tmp_path, """
        assert os.environ["DMLC_PS_ROOT_URI"] == "127.0.0.1"
        assert os.environ["DMLC_ROLE"] == "worker"
        assert os.environ["ELASTIC_TRAINING_ENABLED"] == "1"
        assert os.environ["XLA_FLAGS"] == "--forwarded"
        assert "LOCAL_ONLY_SENTINEL" not in os.environ, "env leaked"
        c.barrier()
    """)
    monkeypatch.setenv("LOCAL_ONLY_SENTINEL", "1")
    monkeypatch.setenv("XLA_FLAGS", "--forwarded")  # a JAX worker reads it
    rcs = launch_ssh(1, [sys.executable, script], str(hostfile),
                     elastic=True, ssh_cmd=_fake_ssh(tmp_path),
                     root_uri="127.0.0.1", workdir=str(tmp_path))
    assert rcs == {"solo": 0}


def test_launch_ssh_elastic_add_dials_new_host(tmp_path):
    hostfile = tmp_path / "host_worker"
    hostfile.write_text("alpha\nbeta\n")
    script = _trainee(tmp_path, f"""
        begin = int(os.environ.get("EPOCH_BEGIN", "0"))
        for epoch in range(begin, 4):
            if me == "alpha" and epoch == 2:
                tmp = {str(hostfile)!r} + ".tmp"
                open(tmp, "w").write("alpha\\nbeta\\ngamma\\n")
                os.replace(tmp, {str(hostfile)!r})
            c.membership_change_barrier({{"EPOCH_BEGIN": epoch}})
        open(os.path.join(out, me + ".ok"), "w").write(
            f"{{c.rank}}/{{c.num_workers}} {{os.environ.get('NEW_WORKER')}}")
    """)
    rcs = launch_ssh(2, [sys.executable, script], str(hostfile),
                     elastic=True, ssh_cmd=_fake_ssh(tmp_path),
                     root_uri="127.0.0.1", workdir=str(tmp_path))
    assert rcs == {"alpha": 0, "beta": 0, "gamma": 0}
    dialed = open(str(tmp_path / "ssh_dials.log")).read().split()
    assert sorted(set(dialed)) == ["alpha", "beta", "gamma"]
    assert open(str(tmp_path / "gamma.ok")).read() == "2/3 1"


def test_launch_ssh_requires_enough_hosts(tmp_path):
    hostfile = tmp_path / "host_worker"
    hostfile.write_text("only-one\n")
    with pytest.raises(ValueError):
        launch_ssh(2, ["true"], str(hostfile),
                   ssh_cmd=_fake_ssh(tmp_path), root_uri="127.0.0.1")
    assert protocol._SECRET_OVERRIDE is None


def test_launch_ssh_secret_not_in_argv(tmp_path, monkeypatch):
    """The generated secret reaches an ssh worker through stdin, never the
    remote command line, and the worker is authenticated end to end."""
    monkeypatch.delenv("DT_ELASTIC_SECRET", raising=False)
    monkeypatch.delenv("DT_ELASTIC_INSECURE", raising=False)
    hostfile = tmp_path / "host_worker"
    hostfile.write_text("solo\n")
    script = _trainee(tmp_path, """
        assert len(os.environ.get("DT_ELASTIC_SECRET", "")) >= 32
        c.barrier()
        open(os.path.join(out, "secret.out"), "w").write(
            os.environ["DT_ELASTIC_SECRET"])
    """)
    rcs = launch_ssh(1, [sys.executable, script], str(hostfile),
                     elastic=True, ssh_cmd=_fake_ssh(tmp_path, True),
                     root_uri="127.0.0.1", workdir=str(tmp_path))
    assert rcs == {"solo": 0}
    secret = open(str(tmp_path / "secret.out")).read()
    argv_log = open(str(tmp_path / "ssh_argv.log")).read()
    assert secret not in argv_log
    assert "read -r DT_ELASTIC_SECRET" in argv_log
