"""The policy engine of the port (counterpart of ``dt_tpu/policy``):
straggler-adaptive dynamic mini-batch shares, the gradient weights that
keep the global batch's update, and auto-eviction of chronic stragglers.
The serving autoscaler (``ServePolicy``) comes with the serve gateway
(ROADMAP Queue 1 item 5)."""

from dt_tpu_torch.policy import rescale as rescale
from dt_tpu_torch.policy.engine import (Decision as Decision,
                                        PolicyEngine as PolicyEngine,
                                        enabled as enabled)
