"""The serving plane of the port (counterpart of ``dt_tpu/serve``):
dynamic-batched inference on a fleet of replicas.

- :mod:`~dt_tpu_torch.serve.gateway`: a replica's request server over the
  pooled transport: deadline-aware dynamic batching into the ``Predictor``'s
  batch buckets, bounded admission (counted shed), idempotent ``infer``
  (token-cached answers survive retries).
- :mod:`~dt_tpu_torch.serve.replica`: gateway, predictor and the control
  client that registers with the scheduler and heartbeats the live serve
  gauges; it follows a scheduler failover through ``DT_CTRL_ENDPOINTS``.
- :mod:`~dt_tpu_torch.serve.refresh`: rolling weight refresh from the
  committed fleet-checkpoint manifest, one replica at a time,
  drain-then-swap (every answer comes from the old or from the new weights,
  never a torn mix).
- :mod:`~dt_tpu_torch.serve.client`: the request side (``InferClient``):
  discovery through ``serve_endpoints``, retry with one token across
  replica kills.

The autoscaling policy lives with the training policy engine
(``policy.ServePolicy``); the scheduler evaluates it on serve heartbeats.
The wire is the JAX package's, so port replicas register with its scheduler
and its replicas with the port's.
"""

from dt_tpu_torch.serve.client import InferClient  # noqa: F401
from dt_tpu_torch.serve.gateway import DynamicBatcher, Gateway  # noqa: F401
from dt_tpu_torch.serve.refresh import RollingRefresher  # noqa: F401
from dt_tpu_torch.serve.replica import Replica, ServeClient  # noqa: F401
