"""Training callbacks of the port (counterpart of
``dt_tpu/training/callbacks.py``).

Reference: ``python/mxnet/callback.py`` (Speedometer, do_checkpoint,
LogValidationMetricsCallback) and the elastic-aware Speedometer of
``example/dynamic-training/train_resnet.py:381-390``, which rescales the
throughput by the live worker count.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

from dt_tpu_torch.training import checkpoint as ckpt_lib

logger = logging.getLogger("dt_tpu_torch")


class BatchEndParam:
    """Reference ``mx.model.BatchEndParam``."""

    __slots__ = ("epoch", "nbatch", "eval_metric", "locals")

    def __init__(self, epoch: int, nbatch: int, eval_metric=None, local=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = local


class Speedometer:
    """Log samples/sec every ``frequent`` batches.

    ``num_workers_fn`` makes it elastic-aware: the reported throughput is
    the per-worker rate times the live worker count.  ``speeds`` keeps
    every rate it logged (samples/sec, host clock between two batch ends
    of the metric that runs one step behind)."""

    def __init__(self, batch_size: int, frequent: int = 50,
                 auto_reset: bool = True,
                 num_workers_fn: Optional[Callable[[], int]] = None):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.num_workers_fn = num_workers_fn
        self.init = False
        self.tic = 0.0
        self.last_count = 0
        self.speeds = []

    def __call__(self, param: BatchEndParam):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / \
                    (time.time() - self.tic)
                if self.num_workers_fn is not None:
                    speed *= self.num_workers_fn()
                self.speeds.append(speed)
                if param.eval_metric is not None:
                    nv = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "\t".join(f"{n}={v:.6f}" for n, v in nv)
                    logger.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                                "\t%s", param.epoch, count, speed, msg)
                else:
                    logger.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                                param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


def do_checkpoint(prefix: str, period: int = 1, meta: Optional[dict] = None,
                  async_save: bool = False):
    """Epoch-end callback saving the whole train state every ``period``
    epochs (reference ``mx.callback.do_checkpoint``, with the optimizer
    state) as ``prefix-%04d.state`` in the JAX package's format.
    ``async_save=True`` overlaps the encoding and the write with the next
    epoch (``dt_tpu/training/callbacks.py:78-100``); a failed background
    write re-raises from the next call."""
    period = max(period, 1)
    failed: list = []

    def _callback(epoch: int, state, metrics=None):
        if failed:
            raise RuntimeError(
                "previous async checkpoint write failed") from failed[0]
        if (epoch + 1) % period == 0:
            out = ckpt_lib.save_checkpoint(prefix, epoch, state, meta,
                                           async_save=async_save)
            if async_save:
                def _report(f):
                    err = f.exception()
                    if err is not None:
                        logger.error("ASYNC CHECKPOINT WRITE FAILED (%s): "
                                     "later restores will miss this "
                                     "epoch", err)
                        failed.append(err)
                    else:
                        logger.info("Saved checkpoint to \"%s\"",
                                    f.result())
                out.add_done_callback(_report)
            else:
                logger.info("Saved checkpoint to \"%s\"", out)
    return _callback


def log_validation_metrics(epoch: int, metric) -> None:
    """Reference ``LogValidationMetricsCallback``."""
    for name, value in metric.get_name_value():
        logger.info("Epoch[%d] Validation-%s=%f", epoch, name, value)
