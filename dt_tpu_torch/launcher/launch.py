"""The job launcher of the port, with the reference's command line
(counterpart of ``dt_tpu/launcher/launch.py``, copied since the port
imports nothing of the JAX package).

Reference: ``tools/launch.py`` (``launch.py -n N -H hostfile
--elastic-training-enabled True python train.py ...``); its dmlc-tracker
"local" launcher starts every role on one machine.

    python -m dt_tpu_torch.launcher.launch -n 2 -H host_worker \\
        --elastic-training-enabled True [--standby] [-s S] -- <command>

``local``: the port's ``Scheduler`` runs in this process; ``-s S`` starts S
range servers (``python -m dt_tpu_torch.elastic.range_server``) before the
workers; ``--standby`` journals the scheduler's state and starts a warm
standby (``python -m dt_tpu_torch.elastic.scheduler_main --standby``) on
the same journal, and every worker gets both endpoints in
``DT_CTRL_ENDPOINTS``; ``DT_RESUME=1`` replays the journal for a
cold-restart resume.  N worker processes run ``command`` with the env
contract the fit loop reads (``ELASTIC_TRAINING_ENABLED``,
``DMLC_PS_ROOT_URI``/``PORT``, ``DT_WORKER_ID``); a host the host_worker
file gains is started by the scheduler's launch callback with the same
command and ``NEW_WORKER=1``, ``EPOCH_BEGIN`` (``TRAINING_CMD``,
``elastic_training.cc:26-62``).  A worker the policy engine evicts leaves
``fit`` through ``WorkerRemoved`` and exits 0.

``ssh``: the same protocol with each worker started as ``ssh <host>
'export ...; cd ...; exec <command>'`` (``dmlc_tracker/ssh.py``): the env
contract rides the remote command line, the HMAC secret the ssh stdin.
``--ssh-cmd`` is injectable, so the protocol is testable without sshd.

The control plane authenticates every frame with a per-job secret
(``DT_ELASTIC_SECRET``, generated when unset; ``DT_ELASTIC_INSECURE=1``
opts out): the in-process scheduler gets it through
``protocol.set_secret``, never ``os.environ``.
"""

from __future__ import annotations

import argparse
import logging
import os
import subprocess
import sys
import time
from typing import List, Optional

from dt_tpu_torch import config

logger = logging.getLogger("dt_tpu_torch.launcher")


def _job_secret() -> Optional[str]:
    """The job's HMAC secret: ``DT_ELASTIC_SECRET`` if set, else a fresh
    per-job one, or ``None`` under ``DT_ELASTIC_INSECURE=1``.  The control
    frames are pickled dicts, so an unauthenticated plane would run what
    any peer sends."""
    s = config.env("DT_ELASTIC_SECRET")
    if s:
        return s
    if config.env("DT_ELASTIC_INSECURE").lower() in ("1", "true"):
        logger.warning("elastic control plane running UNAUTHENTICATED "
                       "(DT_ELASTIC_INSECURE set)")
        return None
    import secrets
    logger.info("generated per-job DT_ELASTIC_SECRET; control frames are "
                "HMAC-authenticated")
    return secrets.token_hex(32)


def _worker_env(base: dict, scheduler_port: int, worker_id: str,
                hostfile: Optional[str], elastic: bool,
                extra: Optional[dict] = None) -> dict:
    env = dict(base)
    env["DMLC_PS_ROOT_URI"] = "127.0.0.1"
    env["DMLC_PS_ROOT_PORT"] = str(scheduler_port)
    env["DT_WORKER_ID"] = worker_id
    env["DMLC_ROLE"] = "worker"
    if hostfile:
        env["WORKER_HOST_FILE"] = hostfile
    if elastic:
        env["ELASTIC_TRAINING_ENABLED"] = "1"
    env.update(extra or {})
    return env


def _await_servers(sched, n_servers: int, timeout: float = 60.0) -> None:
    """Wait until the range-server fleet registered: a worker that
    registers earlier gets no server list and uses the scheduler's plane
    (the reference waits for ``DMLC_NUM_SERVER`` servers,
    ``van.cc:95-185``)."""
    deadline = time.time() + timeout
    while len(sched._server_list()) < n_servers:
        if time.time() > deadline:
            raise RuntimeError(
                f"only {len(sched._server_list())}/{n_servers} range "
                "servers registered")
        time.sleep(0.1)


def _await_port_file(path: str, timeout: float = 30.0) -> int:
    """The port a ``scheduler_main`` child bound (the standby binds port
    0; ``DT_CTRL_ENDPOINTS`` needs the number before any worker starts)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with open(path) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            time.sleep(0.05)
    raise RuntimeError(f"standby scheduler never wrote {path}")


def _reap_all(procs: dict) -> dict:
    """Wait for every process, re-reading ``procs`` until it stops
    growing: the launch callback may still add joiners while base workers
    are reaped."""
    rcs = {}
    while True:
        pending = [(h, p) for h, p in list(procs.items()) if h not in rcs]
        if not pending:
            return rcs
        for h, p in pending:
            rcs[h] = p.wait()


def launch_local(num_workers: int, command: List[str],
                 hostfile: Optional[str] = None, elastic: bool = False,
                 scheduler_port: int = 0, num_servers: int = 0,
                 standby: bool = False, ha_dir: Optional[str] = None):
    """Start the scheduler (here), ``num_servers`` range servers and
    ``num_workers`` local workers; returns the workers' exit codes by
    host.  ``standby=True``: the scheduler journals its state in
    ``ha_dir`` (default: a fresh temporary directory) and a warm-standby
    process tails it; workers fail over through ``DT_CTRL_ENDPOINTS``."""
    from dt_tpu_torch.elastic import protocol
    from dt_tpu_torch.elastic.scheduler import Scheduler, _read_hosts

    secret = _job_secret()
    protocol.set_secret(secret)

    hosts = [f"worker-{i}" for i in range(num_workers)]
    if hostfile and os.path.exists(hostfile):
        listed = _read_hosts(hostfile)
        if listed:
            hosts = listed[:num_workers] + hosts[len(listed):]

    procs = {}
    server_procs = {}
    secret_env = {"DT_ELASTIC_SECRET": secret} if secret else {}

    journal = lease = None
    standby_proc = None
    standby_port = None
    if standby:
        import tempfile
        had = ha_dir or tempfile.mkdtemp(prefix="dt_ctrl_ha_")
        os.makedirs(had, exist_ok=True)
        journal = os.path.join(had, "ctrl.journal")
        lease = os.path.join(had, "ctrl.lease")
        port_file = os.path.join(had, "standby.port")
        standby_proc = subprocess.Popen(
            [sys.executable, "-m", "dt_tpu_torch.elastic.scheduler_main",
             "--standby", "--journal", journal, "--lease", lease,
             "--port-file", port_file]
            + (["--host-worker-file", hostfile] if hostfile else []),
            env={**os.environ, **secret_env})
        standby_port = _await_port_file(port_file)
        logger.info("warm-standby scheduler on :%d (journal %s)",
                    standby_port, journal)

    # filled in place once the scheduler bound its port, so launch_new
    # (the launch callback, which a replayed membership change may fire
    # during construction) never reads an unbound name
    endpoints_env: dict = {}

    def launch_new(host: str, epoch: int):
        logger.info("launching elastic worker %s (EPOCH_BEGIN=%d)", host,
                    epoch)
        procs[host] = subprocess.Popen(
            command, env=_worker_env(
                os.environ, sched.port, host, hostfile, elastic,
                {"NEW_WORKER": "1", "EPOCH_BEGIN": str(epoch),
                 "TRAINING_CMD": " ".join(command), **secret_env,
                 **endpoints_env}))

    sched = Scheduler(host_worker_file=hostfile, initial_workers=hosts,
                      port=scheduler_port,
                      launch_callback=launch_new if elastic else None,
                      journal_path=journal, lease_path=lease,
                      peer=("127.0.0.1", standby_port) if standby else None,
                      resume=bool(config.env("DT_RESUME")))
    if standby:
        endpoints_env["DT_CTRL_ENDPOINTS"] = \
            f"127.0.0.1:{sched.port},127.0.0.1:{standby_port}"
    logger.info("scheduler on :%d; starting %d servers + %d workers",
                sched.port, num_servers, num_workers)
    try:
        for i in range(num_servers):
            env = dict(os.environ)
            env.update(secret_env)
            env["DMLC_ROLE"] = "server"
            # a local fleet advertises loopback: a machine without its own
            # hostname in /etc/hosts would register an unresolvable name
            env.setdefault("DT_ELASTIC_ADVERTISE", "127.0.0.1")
            server_procs[f"server-{i}"] = subprocess.Popen(
                [sys.executable, "-m", "dt_tpu_torch.elastic.range_server",
                 "--scheduler-host", "127.0.0.1",
                 "--scheduler-port", str(sched.port),
                 "--index", str(i)], env=env)
        if num_servers:
            _await_servers(sched, num_servers)
        for h in hosts:
            procs[h] = subprocess.Popen(
                command, env=_worker_env(os.environ, sched.port, h, hostfile,
                                         elastic,
                                         {"TRAINING_CMD": " ".join(command),
                                          **secret_env, **endpoints_env}))
        return _reap_all(procs)
    finally:
        sched.close()
        if standby_proc is not None:
            _stop_standby(standby_proc, standby_port)
        protocol.set_secret(None)
        for p in list(procs.values()) + list(server_procs.values()):
            if p.poll() is None:
                p.terminate()


def _stop_standby(proc: subprocess.Popen, port: int) -> None:
    """Stop the standby with the ``shutdown`` command (its SIGTERM asks the
    fleet for a checkpoint instead), and kill it if it is still up after
    10 s.  The command closes the connection unanswered."""
    from dt_tpu_torch.elastic import protocol
    if proc.poll() is None:
        try:
            protocol.request("127.0.0.1", port, {"cmd": "shutdown"},
                             timeout=5.0, retries=0)
        except (OSError, RuntimeError):
            pass
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


#: what the ssh launcher forwards of the local environment; the XLA and
#: JAX variables stay, since a mixed fleet's JAX workers read them
_FORWARD_ENV_PREFIXES = ("DMLC_", "DT_", "PYTHONPATH", "WORKER_HOST_FILE",
                         "ELASTIC_TRAINING_ENABLED", "NEW_WORKER",
                         "EPOCH_BEGIN", "TRAINING_CMD", "XLA_FLAGS",
                         "JAX_PLATFORMS")


def _ssh_popen(host: str, command: List[str], env: dict, ssh_cmd: str,
               workdir: str,
               secret: Optional[str] = None) -> subprocess.Popen:
    """Start ``command`` on ``host`` over ssh, the launch env exported in
    the remote command line.  The secret is piped over ssh's stdin into a
    shell ``read``, never put in argv, which process listings show on
    both ends."""
    import shlex
    exports = "".join(
        f"export {k}={shlex.quote(str(v))}; " for k, v in sorted(env.items())
        if k != "DT_ELASTIC_SECRET"
        and any(k.startswith(p) for p in _FORWARD_ENV_PREFIXES))
    prefix = ""
    if secret:
        prefix = "IFS= read -r DT_ELASTIC_SECRET; export DT_ELASTIC_SECRET; "
    remote = (prefix + exports + f"cd {shlex.quote(workdir)}; exec "
              + " ".join(shlex.quote(c) for c in command))
    proc = subprocess.Popen(shlex.split(ssh_cmd) + [host, remote],
                            stdin=subprocess.PIPE if secret else None)
    if secret:
        try:
            proc.stdin.write((secret + "\n").encode())
            proc.stdin.flush()
            proc.stdin.close()
        except (BrokenPipeError, OSError) as e:
            # ssh died before reading (a dead host): the reaper sees its
            # exit code; the launch thread must not die here
            print(f"# launch: ssh to {host} exited before secret hand-off "
                  f"({e})", file=sys.stderr)
    return proc


def _default_root_uri() -> str:
    import socket
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def launch_ssh(num_workers: int, command: List[str], hostfile: str,
               elastic: bool = False, scheduler_port: int = 0,
               ssh_cmd: str = "ssh -o StrictHostKeyChecking=no",
               root_uri: Optional[str] = None,
               workdir: Optional[str] = None, num_servers: int = 0):
    """The scheduler in this process, one worker a host_worker line over
    ssh (``tools/launch.py``'s ssh path); joiners are started over the
    same channel.  Returns the workers' exit codes by host."""
    from dt_tpu_torch.elastic import protocol
    from dt_tpu_torch.elastic.scheduler import Scheduler, _read_hosts

    secret = _job_secret()
    protocol.set_secret(secret)
    hosts = _read_hosts(hostfile)[:num_workers]
    if len(hosts) < num_workers:
        protocol.set_secret(None)
        raise ValueError(
            f"hostfile lists {len(hosts)} hosts, need {num_workers}")
    uri = root_uri or _default_root_uri()
    wd = workdir or os.getcwd()
    procs = {}

    def env_for(host, extra=None):
        env = _worker_env(os.environ, sched.port, host, hostfile, elastic,
                          {"TRAINING_CMD": " ".join(command),
                           **(extra or {})})
        env["DMLC_PS_ROOT_URI"] = uri
        return env

    def launch_new(host: str, epoch: int):
        logger.info("ssh-launching elastic worker %s (EPOCH_BEGIN=%d)",
                    host, epoch)
        procs[host] = _ssh_popen(
            host, command,
            env_for(host, {"NEW_WORKER": "1", "EPOCH_BEGIN": str(epoch)}),
            ssh_cmd, wd, secret=secret)

    sched = Scheduler(host_worker_file=hostfile, initial_workers=hosts,
                      launch_callback=launch_new if elastic else None,
                      port=scheduler_port,
                      resume=bool(config.env("DT_RESUME")))
    logger.info("scheduler on %s:%d; ssh-starting %d workers", uri,
                sched.port, num_workers)
    server_procs = {}
    try:
        # range servers go round-robin over the same hosts
        for i in range(num_servers):
            shost = hosts[i % len(hosts)]
            env = env_for(shost, {"DMLC_ROLE": "server"})
            server_procs[f"server-{i}"] = _ssh_popen(
                shost,
                [sys.executable, "-m", "dt_tpu_torch.elastic.range_server",
                 "--scheduler-host", uri,
                 "--scheduler-port", str(sched.port),
                 "--index", str(i)],
                env, ssh_cmd, wd, secret=secret)
        if num_servers:
            _await_servers(sched, num_servers)
        for h in hosts:
            procs[h] = _ssh_popen(h, command, env_for(h), ssh_cmd, wd,
                                  secret=secret)
        return _reap_all(procs)
    finally:
        sched.close()
        protocol.set_secret(None)
        for p in list(procs.values()) + list(server_procs.values()):
            if p.poll() is None:
                p.terminate()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="dt_tpu_torch job launcher (the reference "
                    "tools/launch.py command line)")
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("-s", "--num-servers", type=int, default=0,
                    help="range servers (DMLC_NUM_SERVER); 0 = the "
                         "scheduler's own data plane")
    ap.add_argument("-H", "--hostfile", default=None,
                    help="host_worker file (the elastic membership)")
    ap.add_argument("--launcher", choices=["local", "ssh"], default="local")
    ap.add_argument("--elastic-training-enabled", default="False",
                    help="True enables the epoch-boundary membership "
                         "protocol")
    ap.add_argument("--standby", action="store_true",
                    help="local launcher: journal the scheduler's state and "
                         "run a warm-standby scheduler process; workers "
                         "fail over through DT_CTRL_ENDPOINTS")
    ap.add_argument("--ha-dir", default=None,
                    help="directory of the journal and lease files "
                         "(default: a fresh temporary directory)")
    ap.add_argument("--scheduler-port", type=int, default=0)
    ap.add_argument("--ssh-cmd", default="ssh -o StrictHostKeyChecking=no",
                    help="ssh launcher: the command that reaches a host")
    ap.add_argument("--root-uri", default=None,
                    help="ssh launcher: the address workers dial back "
                         "(default: this host's IP)")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]  # REMAINDER keeps the separator
    if not args.command:
        ap.error("no training command given")
    elastic = str(args.elastic_training_enabled).lower() in ("1", "true")
    logging.basicConfig(level=logging.INFO)
    if args.launcher == "ssh":
        if not args.hostfile:
            ap.error("ssh launcher requires -H hostfile")
        if args.standby:
            # the journal and lease need a file system both schedulers
            # see: the local launcher has one, ssh cannot assume it
            ap.error("--standby is local-launcher only (the ssh "
                     "launcher cannot assume a shared journal path)")
        rcs = launch_ssh(args.num_workers, args.command, args.hostfile,
                         elastic, args.scheduler_port, args.ssh_cmd,
                         args.root_uri, num_servers=args.num_servers)
    else:
        rcs = launch_local(args.num_workers, args.command, args.hostfile,
                           elastic, args.scheduler_port,
                           num_servers=args.num_servers,
                           standby=args.standby, ha_dir=args.ha_dir)
    bad = {h: rc for h, rc in rcs.items() if rc != 0}
    if bad:
        logger.error("workers failed: %s", bad)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
