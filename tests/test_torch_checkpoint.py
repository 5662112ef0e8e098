"""Checkpoints across the two packages, on the CPU.

A ``resnet20`` train state (params, BN stats, SGD momentum, step) written
by the port's ``callbacks.do_checkpoint`` is restored by the JAX package's
``load_checkpoint`` (its digest checked) to equal leaves, and one written
by the JAX package's ``save_checkpoint`` is read by the port's
``load_checkpoint`` to equal params and stats.  The port's msgpack encoder
writes the same bytes as flax's serializer for the same tree.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from dt_tpu import models as jmodels
from dt_tpu import optim as joptim
from dt_tpu.training import checkpoint as jckpt
from dt_tpu.training.train_state import TrainState as JState
from dt_tpu_torch import models as tmodels
from dt_tpu_torch import optim as toptim
from dt_tpu_torch.interchange import export_jax_train_state
from dt_tpu_torch.training import callbacks as tcb
from dt_tpu_torch.training import checkpoint as tckpt
from dt_tpu_torch.training.step import train_step
from dt_tpu_torch.training.train_state import TrainState
from dt_tpu_torch.utils import msgpack as tmsgpack
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

SGD = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)


def _jax_template():
    model = jmodels.create("resnet20", num_classes=10)
    v = model.init({"params": jax.random.PRNGKey(3)},
                   jnp.zeros((1, 8, 8, 3)), training=False)
    return JState.create(model.apply, v["params"],
                         joptim.create("sgd", **SGD), v["batch_stats"])


def _port_state(steps=2):
    model = tmodels.init_params(tmodels.create("resnet20", device="cpu"), 1)
    state = TrainState.create(model, toptim.create("sgd", **SGD))
    rng = np.random.RandomState(0)
    for _ in range(steps):
        x = torch.from_numpy(rng.uniform(-1, 1, (4, 8, 8, 3)).astype(
            np.float32)).permute(0, 3, 1, 2)
        train_step(state, x, torch.from_numpy(rng.randint(0, 10, 4)))
    return state


def _flat(tree):
    return np.asarray(ravel_pytree(jax.device_get(tree))[0])


def test_port_checkpoint_restores_in_the_jax_package(tmp_path):
    state = _port_state()
    prefix = str(tmp_path / "ck")
    tcb.do_checkpoint(prefix, meta={"model": "resnet20"})(4, state)
    meta = jckpt.read_meta(prefix)
    assert meta["model"] == "resnet20" and "0004" in meta["checkpoints"]
    restored = jckpt.load_checkpoint(prefix, 4, _jax_template())
    want = export_jax_train_state(state)
    assert int(restored.step) == state.step == 2
    assert int(restored.opt_state.count) == 2
    for got, exp in ((restored.params, want["params"]),
                     (restored.batch_stats, want["batch_stats"]),
                     (restored.opt_state.mom, want["opt_state"]["mom"])):
        np.testing.assert_array_equal(_flat(got), _flat(exp))
    # the port's own reader takes it too, and a flipped byte is refused
    back = tckpt.load_checkpoint(prefix, 4)
    np.testing.assert_array_equal(_flat(back["params"]),
                                  _flat(want["params"]))
    path = tmp_path / "ck-0004.state"
    blob = bytearray(path.read_bytes())
    blob[-1] ^= 1
    path.write_bytes(bytes(blob))
    with pytest.raises(tckpt.CheckpointCorruptError, match="sha256"):
        tckpt.load_checkpoint(prefix, 4)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    template = _jax_template()
    prefix = str(tmp_path / "jk")
    jckpt.save_checkpoint(prefix, 7, template.replace(step=jnp.int32(5)))
    got = tckpt.load_checkpoint(prefix, 7)
    assert int(np.asarray(got["step"])) == 5
    np.testing.assert_array_equal(_flat(got["params"]),
                                  _flat(template.params))
    np.testing.assert_array_equal(_flat(got["batch_stats"]),
                                  _flat(template.batch_stats))
    assert tckpt.latest_checkpoint(prefix) == 7


def test_encoder_writes_flax_bytes():
    """``utils.msgpack.pack`` against flax's serializer on one tree of
    every kind the checkpoints hold (nested dicts, f32/int32/bf16 arrays,
    numpy scalars, Python ints, floats and strings, an empty dict), and
    both readers restore it."""
    rng = np.random.RandomState(2)
    f32 = rng.normal(size=(3, 4)).astype(np.float32)
    bf = jnp.asarray(rng.normal(size=(5,)), jnp.bfloat16)
    tree = {"a": {"w": f32, "i": np.arange(6, dtype=np.int32).reshape(2, 3),
                  "empty": {}},
            "count": np.int32(7), "n": 3, "neg": -40, "big": 70000,
            "x": 1.5, "s": "txt", "long": np.zeros((300,), np.float32)}
    ours = tmsgpack.pack({**tree, "bf": torch.from_numpy(
        np.array(bf).view(np.int16)).view(torch.bfloat16)})
    theirs = flax.serialization.msgpack_serialize({**tree, "bf": bf})
    assert ours == theirs
    back = flax.serialization.msgpack_restore(ours)
    np.testing.assert_array_equal(back["a"]["w"], f32)
    mine = tmsgpack.restore(theirs)
    assert mine["bf"].dtype == torch.bfloat16 and mine["count"] == 7
