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


#: the optimizer states a checkpoint carries besides SGD's: two slots,
#: nadam's 0-d ``c``, sgld's ``uint32[2]`` key, lamb's chain and the
#: multi-precision masters
_OPTS = {"adam": ("adam", dict(learning_rate=1e-3, weight_decay=1e-4)),
         "nadam": ("nadam", dict(learning_rate=1e-3)),
         "sgld": ("sgld", dict(learning_rate=1e-4, seed=3)),
         "lamb": ("lamb", dict(learning_rate=1e-3, weight_decay=1e-4)),
         "mp_sgd": ("sgd", dict(SGD, multi_precision=True))}


def _opt_template(case):
    name, kw = _OPTS[case]
    model = jmodels.create("resnet20", num_classes=10)
    v = model.init({"params": jax.random.PRNGKey(3)},
                   jnp.zeros((1, 8, 8, 3)), training=False)
    return JState.create(model.apply, v["params"],
                         joptim.create(name, **kw), v["batch_stats"])


def _port_opt_state(case, steps=2):
    name, kw = _OPTS[case]
    model = tmodels.init_params(tmodels.create("resnet20", device="cpu"), 1)
    state = TrainState.create(model, toptim.create(name, **kw))
    rng = np.random.RandomState(0)
    for _ in range(steps):
        x = torch.from_numpy(rng.uniform(-1, 1, (4, 8, 8, 3)).astype(
            np.float32)).permute(0, 3, 1, 2)
        train_step(state, x, torch.from_numpy(rng.randint(0, 10, 4)))
    return state


@pytest.mark.parametrize("case", sorted(_OPTS))
def test_port_optimizer_checkpoint_restores_in_the_jax_package(tmp_path,
                                                               case):
    """A port checkpoint of each optimizer state restores through the JAX
    package's ``load_checkpoint`` with every leaf equal to the port's
    export, and its bytes are flax's ``msgpack_serialize`` of the restored
    state's ``to_state_dict``."""
    state = _port_opt_state(case)
    prefix = str(tmp_path / "ck")
    tckpt.save_checkpoint(prefix, 2, state)
    restored = jckpt.load_checkpoint(prefix, 2, _opt_template(case))
    want = export_jax_train_state(state)
    got = flax.serialization.to_state_dict(restored)
    assert jax.tree_util.tree_structure(got["opt_state"]) == \
        jax.tree_util.tree_structure(want["opt_state"])
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got["opt_state"])[0],
            jax.tree_util.tree_flatten_with_path(want["opt_state"])[0]):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))
    blob = (tmp_path / "ck-0002.state").read_bytes()
    assert blob == flax.serialization.msgpack_serialize(got)


@pytest.mark.parametrize("case", sorted(_OPTS))
def test_jax_optimizer_checkpoint_restores_in_the_port(tmp_path, case):
    """A JAX checkpoint with every optimizer leaf filled from a seed loads
    into the port's train state of the same optimizer, and the port
    writes it back byte for byte."""
    template = _opt_template(case)
    sd = flax.serialization.to_state_dict(template)
    rng = np.random.RandomState(5)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.uint32:
            return rng.randint(0, 2 ** 31, x.shape).astype(np.uint32)
        if x.dtype == np.int32:
            return np.asarray(3, np.int32)
        return jnp.asarray(rng.normal(0, 1, x.shape), x.dtype)
    sd["opt_state"] = jax.tree_util.tree_map(fill, sd["opt_state"])
    sd["step"] = np.asarray(3, np.int32)
    jstate = flax.serialization.from_state_dict(template, sd)
    prefix = str(tmp_path / "jk")
    jckpt.save_checkpoint(prefix, 3, jstate)
    name, kw = _OPTS[case]
    tstate = TrainState.create(tmodels.create("resnet20", device="cpu"),
                               toptim.create(name, **kw))
    tag, _ = tckpt.load_latest_checkpoint(prefix, tstate)
    assert tag == 3 and tstate.step == 3
    tckpt.save_checkpoint(str(tmp_path / "again"), 3, tstate)
    assert (tmp_path / "again-0003.state").read_bytes() == \
        (tmp_path / "jk-0003.state").read_bytes()
