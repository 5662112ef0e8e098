"""The scheduler as a process of its own (counterpart of
``dt_tpu/elastic/scheduler_main.py``)::

    python -m dt_tpu_torch.elastic.scheduler_main --host-worker-file hw \\
        --port-file port [--auto-evict-dead-s 6]

It starts the port's :class:`~dt_tpu_torch.elastic.scheduler.Scheduler`
(which imports neither torch's CUDA nor JAX, so it starts in about a
second), writes the bound port to ``--port-file`` once listening, and
serves until a ``shutdown`` command.  The HA pair runs two of them:

- the primary: ``--journal J [--lease L] [--lease-s S] [--peer
  standby_host:port]`` journals every control transition and, with
  ``--peer``, replicates completed allreduce rounds to the standby before
  answering;
- the warm standby: ``--standby --journal J [--lease L]`` tails the
  journal, watches the lease and takes over under the next fencing
  incarnation when the primary goes silent.  A launcher starts it first
  and reads its ``--port-file`` into ``DT_CTRL_ENDPOINTS``.

``--resume`` (or ``DT_RESUME=1``) is the cold-restart resume: the journal
replayed, the dead incarnation's fleet cleared, the committed fleet
checkpoint handed to re-registering workers.  The first SIGTERM asks the
fleet for an epoch-boundary checkpoint and keeps serving; a second ends
the process.  A primary with ``--peer`` that dies by an injected
``os._exit`` first pushes its control-plane track to the peer over
``obs_push`` (:func:`_relay_obs`), so the merged job dump keeps the dead
incarnation's records.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
from typing import Tuple


def _parse_addr(spec: str) -> Tuple[str, int]:
    host, _, port = spec.rpartition(":")
    return (host or "127.0.0.1", int(port))


def _relay_obs(sched, peer: Tuple[str, int]) -> None:
    """The crash-path flush hook (``scheduler_main.py:43-64``): this
    process's control-plane track to the peer scheduler, as
    ``sched-primary``; never raises."""
    from dt_tpu_torch.elastic import protocol
    from dt_tpu_torch.obs import trace as obs_trace
    own = sched._obs.snapshot()
    proc = obs_trace.tracer().snapshot()
    payload = {"inc": os.getpid(), "fseq": 1,
               "records": own["records"] + proc["records"],
               "counters": {**proc["counters"], **own["counters"]},
               "dropped": own["dropped"] + proc["dropped"]}
    try:
        protocol.request(peer[0], peer[1],
                         {"cmd": "obs_push", "host": "sched-primary",
                          "obs": payload}, timeout=2.0)
    except (OSError, RuntimeError):
        pass  # observability is never fatal, least of all mid-crash


def _write_atomic(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="dt_tpu_torch elastic scheduler process (HA primary or "
                    "warm standby)")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--port-file", default="",
                    help="write the bound port here once listening")
    ap.add_argument("--host-worker-file", default=None)
    ap.add_argument("--journal", default=None,
                    help="control-state journal path (DT_CTRL_JOURNAL)")
    ap.add_argument("--lease", default=None,
                    help="leader lease file (default <journal>.lease)")
    ap.add_argument("--lease-s", type=float, default=None)
    ap.add_argument("--standby", action="store_true",
                    help="run as the warm standby (journal tail, lease "
                         "watch, takeover)")
    ap.add_argument("--peer", default="",
                    help="host:port of the standby to replicate completed "
                         "rounds to (primary only)")
    ap.add_argument("--expected-workers", type=int, default=None)
    ap.add_argument("--auto-evict-dead-s", type=float, default=None)
    ap.add_argument("--resume", action="store_true",
                    help="cold-restart resume (DT_RESUME): replay the "
                         "journal, clear the dead incarnation's fleet, "
                         "serve the committed fleet checkpoint")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s sched[%(process)d] %(levelname)s %(message)s")
    from dt_tpu_torch import config
    from dt_tpu_torch.elastic.scheduler import Scheduler
    from dt_tpu_torch.obs import trace as obs_trace

    peer = _parse_addr(args.peer) if args.peer else None
    sched = Scheduler(host_worker_file=args.host_worker_file,
                      port=args.port,
                      expected_workers=args.expected_workers,
                      auto_evict_dead_s=args.auto_evict_dead_s,
                      journal_path=args.journal,
                      lease_path=args.lease,
                      lease_s=args.lease_s,
                      standby=args.standby,
                      peer=peer,
                      resume=bool(args.resume or config.env("DT_RESUME")))
    if peer is not None:
        obs_trace.register_flush(lambda: _relay_obs(sched, peer))
    if args.port_file:
        _write_atomic(args.port_file, str(sched.port))
    logging.getLogger("dt_tpu_torch.elastic").info(
        "%s scheduler up on :%d (journal=%s)",
        "standby" if args.standby else "primary", sched.port, args.journal)

    def _drain_sig(signum, frame):
        del frame
        sched.request_fleet_checkpoint()
        try:
            signal.signal(signum, signal.SIG_DFL)
        except (ValueError, OSError):
            pass

    try:
        signal.signal(signal.SIGTERM, _drain_sig)
    except (ValueError, OSError):
        pass
    sched.join()  # until a shutdown command
    sched.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
