"""The scheduler as a process of its own (counterpart of
``dt_tpu/elastic/scheduler_main.py``)::

    python -m dt_tpu_torch.elastic.scheduler_main --host-worker-file hw \\
        --port-file port [--auto-evict-dead-s 6]

It starts the port's :class:`~dt_tpu_torch.elastic.scheduler.Scheduler`
(which imports neither torch's CUDA nor JAX, so it starts in well under a
second), writes the bound port to ``--port-file`` once listening, and
serves until a ``shutdown`` command or SIGTERM.  The HA flags of the JAX
entry (``--journal``, ``--lease``, ``--standby``, ``--peer``) and
``--resume`` are scheduler HA and fleet checkpoints, ROADMAP Queue 1
items 3c and 3e.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="dt_tpu_torch elastic scheduler process")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--port-file", default="",
                    help="write the bound port here once listening")
    ap.add_argument("--host-worker-file", default=None)
    ap.add_argument("--expected-workers", type=int, default=None)
    ap.add_argument("--auto-evict-dead-s", type=float, default=None)
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s sched[%(process)d] %(levelname)s %(message)s")
    from dt_tpu_torch.elastic.scheduler import Scheduler

    sched = Scheduler(host_worker_file=args.host_worker_file,
                      port=args.port,
                      expected_workers=args.expected_workers,
                      auto_evict_dead_s=args.auto_evict_dead_s)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(sched.port))
        os.replace(tmp, args.port_file)
    logging.getLogger("dt_tpu_torch.elastic").info(
        "scheduler up on :%d", sched.port)

    def _term(signum, frame):
        del signum, frame
        sched.close()

    try:
        signal.signal(signal.SIGTERM, _term)
    except (ValueError, OSError):
        pass
    sched.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
