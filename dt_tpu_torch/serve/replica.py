"""The serving replica: a ``Predictor`` and a :class:`~dt_tpu_torch.serve.
gateway.Gateway` wired into the control plane (counterpart of
``dt_tpu/serve/replica.py``, copied since the port imports nothing of the
JAX package).

A :class:`ServeClient` makes the gateway a fleet member: it registers with
the scheduler (``serve_register``), heartbeats the live serve gauges
(``serve_heartbeat``; the queue depth feeds the ``ServePolicy``
autoscaler) and drains the gateway when the scheduler asks on a
scale-down.  It rotates through ``DT_CTRL_ENDPOINTS`` as the training
``WorkerClient`` does: a heartbeat answered by a freshly promoted standby,
whose serve table is empty, comes back ``registered: false`` and the client
registers again, so the serving view reconverges within a heartbeat and no
in-flight request is touched (inference never crosses the scheduler).

``python -m dt_tpu_torch.serve.replica`` is the process entry: a
deterministic toy linear model (:func:`params_for_step`, weights derived
from the refresh step, so the rolling-refresh drills can check exact
answers), or with ``--onnx`` an ONNX artifact through
``Predictor.from_onnx``, on ``--device`` (``cuda`` unless asked for
``cpu``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np

from dt_tpu_torch import config
from dt_tpu_torch.elastic import protocol
from dt_tpu_torch.elastic.client import parse_endpoints
from dt_tpu_torch.serve.gateway import Gateway

logger = logging.getLogger("dt_tpu_torch.serve")


class ServeClient:
    """The control-plane side of a replica: register and heartbeat with
    endpoint rotation (``DT_CTRL_ENDPOINTS``), and the drain callback."""

    def __init__(self, endpoints: Union[str, Sequence[Tuple[str, int]]],
                 host: str, addr: Tuple[str, int],
                 gauges_fn: Callable[[], dict],
                 weights_fn: Callable[[], int],
                 refreshes_fn: Callable[[], int],
                 drain_cb: Optional[Callable[[], None]] = None,
                 heartbeat_s: float = 0.25):
        self.addrs = parse_endpoints(endpoints) \
            if isinstance(endpoints, str) else [tuple(a) for a in endpoints]
        if not self.addrs:
            raise ValueError("ServeClient needs at least one scheduler "
                             "endpoint")
        self.host = host
        self.addr = tuple(addr)
        self._gauges_fn = gauges_fn
        self._weights_fn = weights_fn
        self._refreshes_fn = refreshes_fn
        self._drain_cb = drain_cb
        self._interval = float(heartbeat_s)
        self._lock = threading.Lock()
        self._leader = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _req(self, msg: dict, timeout: float = 5.0) -> dict:
        """One control request, rotating to the next endpoint on a
        connection failure or a ``not_leader``/``fenced`` answer."""
        last: Optional[BaseException] = None
        delay = 0.05
        for _ in range(max(len(self.addrs), 1) * 4):
            with self._lock:
                host, port = self.addrs[self._leader]
            try:
                resp = protocol.request(host, port, dict(msg),
                                        timeout=timeout)
            except (ConnectionError, OSError) as e:
                last = e
                self._rotate()
                time.sleep(delay)
                delay = protocol.next_backoff(delay, 0.05, 0.5)
                continue
            if resp.get("error") in ("not_leader", "fenced"):
                self._rotate()
                continue
            return resp
        raise ConnectionError(f"no scheduler endpoint answered "
                              f"{msg.get('cmd')!r}: {last!r}")

    def _rotate(self) -> None:
        with self._lock:
            self._leader = (self._leader + 1) % len(self.addrs)

    def register(self) -> None:
        self._req({"cmd": "serve_register", "host": self.host,
                   "addr": list(self.addr),
                   "weights_step": self._weights_fn()})
        logger.info("replica %s registered gateway %s:%d", self.host,
                    self.addr[0], self.addr[1])

    def start(self) -> None:
        self.register()
        self._thread = threading.Thread(target=self._beat_loop,
                                        daemon=True)
        self._thread.start()

    def _beat_loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                resp = self._req(
                    {"cmd": "serve_heartbeat", "host": self.host,
                     "gauges": self._gauges_fn(),
                     "weights_step": self._weights_fn(),
                     "refreshes": self._refreshes_fn()})
            except ConnectionError:
                continue  # keep beating; the rotation already advanced
            if not resp.get("registered"):
                # a freshly promoted standby with an empty serve table
                try:
                    self.register()
                except ConnectionError:
                    pass
            if resp.get("drain") and self._drain_cb is not None:
                self._drain_cb()

    def close(self) -> None:
        self._stop.set()


class Replica:
    """A gateway, its predictor and a ServeClient: one serving fleet
    member."""

    def __init__(self, predictor, host: str,
                 scheduler: Union[str, Sequence[Tuple[str, int]]],
                 port: int = 0,
                 refresh_loader: Optional[Callable] = None,
                 heartbeat_s: float = 0.25,
                 advertise_host: Optional[str] = None):
        self.host = host
        self.gateway = Gateway(predictor, port=port,
                               name=f"serve-{host}",
                               refresh_loader=refresh_loader)
        addr = (advertise_host or protocol.advertise_host(),
                self.gateway.port)
        self.client = ServeClient(
            scheduler, host, addr,
            gauges_fn=self.gateway.gauges,
            weights_fn=lambda: self.gateway.weights_step,
            refreshes_fn=lambda: self.gateway.stats()["refreshes"],
            drain_cb=self.gateway.drain,
            heartbeat_s=heartbeat_s)
        self.client.start()

    def close(self) -> None:
        self.client.close()
        self.gateway.close()

    def serve_forever(self) -> None:
        while not self.gateway._stop.wait(0.5):
            pass


def params_for_step(features: int, classes: int, step: int) -> dict:
    """Toy weights keyed by the refresh step, a pure function of (shapes,
    step): the drills check exact answers a step."""
    w = ((np.arange(features * classes, dtype=np.float64)
          .reshape(features, classes) * (step + 1)) % 7 - 3) * 0.1
    return {"w": w.astype(np.float32)}


def toy_predictor(features: int = 8, classes: int = 4,
                  max_batch: int = 64,
                  buckets: Optional[Sequence[int]] = None,
                  step: int = 0, device="cuda"):
    """A ``Predictor.from_fn`` linear model ``x @ w`` with
    :func:`params_for_step` weights (the serve tests' replica).  The
    weights stay numpy, as the refresh loader hands them in."""
    import torch

    from dt_tpu_torch.predictor import Predictor

    def fwd(params, _stats, x):
        return x @ torch.from_numpy(params["w"]).to(x.device, x.dtype)

    return Predictor.from_fn(fwd, params_for_step(features, classes, step),
                             batch_buckets=buckets, max_batch=max_batch,
                             device=device)


def main() -> None:
    """``python -m dt_tpu_torch.serve.replica --scheduler h:p --host w0
    [--device cpu] [--onnx model.onnx]``: the toy linear model, or the
    ONNX artifact, behind a replica."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler", required=True,
                    help="DT_CTRL_ENDPOINTS-style spec host:port[,h:p]")
    ap.add_argument("--host", required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--features", type=int, default=8)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--max-batch", type=int,
                    default=int(config.env("DT_SERVE_MAX_BATCH")))
    ap.add_argument("--weights-step", type=int, default=0)
    ap.add_argument("--onnx", default=None,
                    help="serve this ONNX artifact instead of the toy "
                         "linear model (no refresh loader)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    ap.add_argument("--port-file", default=None,
                    help="write the bound gateway port here")
    args = ap.parse_args()
    device = config.resolve_device(args.device)
    if args.onnx:
        from dt_tpu_torch.predictor import Predictor
        pred = Predictor.from_onnx(args.onnx, max_batch=args.max_batch,
                                   device=device)
        loader = None
    else:
        pred = toy_predictor(args.features, args.classes,
                             max_batch=args.max_batch,
                             step=args.weights_step, device=device)

        def loader(step, _manifest):
            return params_for_step(args.features, args.classes, step)

        pred.warmup(feature_shape=(args.features,))
    rep = Replica(pred, args.host, args.scheduler, port=args.port,
                  refresh_loader=loader, advertise_host="127.0.0.1")
    if args.weights_step:
        # a restarted replica starts mid-history: align the gateway's
        # step so a refresh of the same step stays a no-op
        rep.gateway._weights_step = int(args.weights_step)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(rep.gateway.port))
        os.replace(tmp, args.port_file)
    try:
        rep.serve_forever()
    except KeyboardInterrupt:
        rep.close()


if __name__ == "__main__":
    main()
