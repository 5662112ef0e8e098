"""The policy engine of the port (counterpart of ``dt_tpu/policy``):
straggler-adaptive dynamic mini-batch shares, the gradient weights that
keep the global batch's update, auto-eviction of chronic stragglers, and
the serving autoscaler (``ServePolicy``) that scales the replica set behind
the serve gateway."""

from dt_tpu_torch.policy import rescale as rescale
from dt_tpu_torch.policy.engine import (Decision as Decision,
                                        PolicyEngine as PolicyEngine,
                                        ServeDecision as ServeDecision,
                                        ServePolicy as ServePolicy,
                                        enabled as enabled,
                                        serving_enabled as serving_enabled)
