"""Which side of ``test_torch_cuda.py::test_module_fit_on_card_matches_cpu``
varies from run to run: the test's 2-epoch f32 ``Module.fit`` of
``resnet20`` at one seed, five times each on the card with cuDNN's default
and with its deterministic algorithms, and on the CPU with torch's default
thread count and with one thread; prints each fit's per-epoch train
cross-entropy and its eval cross-entropy (``repr``, every digit).

    python tests/torch_fit_variance.py   # on a machine with a CUDA card

Imports neither JAX nor the JAX package.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from dt_tpu_torch import models  # noqa: E402
from dt_tpu_torch.data import io  # noqa: E402
from dt_tpu_torch.training.module import Module  # noqa: E402

RUNS = 5


def fit_once(dev: torch.device):
    """The test's fit: per-epoch train cross-entropy and the eval score."""
    rng = np.random.RandomState(8)
    x = rng.uniform(-1, 1, (64, 8, 8, 3)).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.int32)
    mod = Module(models.create("resnet20", device=dev, num_classes=10),
                 optimizer="sgd",
                 optimizer_params=dict(learning_rate=0.1, momentum=0.9),
                 device=dev, seed=1)
    it = io.NDArrayIter(x, y, batch_size=32, shuffle=True)
    if dev.type == "cuda":
        it = io.DevicePrefetchIter(it, device=dev)
    ce = []
    mod.fit(it, eval_metric="ce", num_epoch=2,
            epoch_end_callback=lambda e, s, m: ce.append(m.get()[1]))
    score = dict(mod.score(io.NDArrayIter(x, y, 32), "ce"))["cross-entropy"]
    return [repr(c) for c in ce] + [repr(score)]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fit_variance: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    threads = torch.get_num_threads()
    cases = (("card, cuDNN default algorithms", "cuda", False, threads),
             ("card, cuDNN deterministic", "cuda", True, threads),
             (f"cpu, {threads} threads", "cpu", False, threads),
             ("cpu, 1 thread", "cpu", False, 1))
    for tag, dev, det, n in cases:
        torch.backends.cudnn.deterministic = det
        torch.set_num_threads(n)
        rows = [fit_once(torch.device(dev)) for _ in range(RUNS)]
        print(f"{tag}: {json.dumps(rows)}", flush=True)
    torch.set_num_threads(threads)
    return 0


if __name__ == "__main__":
    sys.exit(main())
