"""The port's checkpoint reader and Predictor against ``dt_tpu``'s.

A ``resnet20`` TrainState is saved with ``dt_tpu``'s own
``save_checkpoint``; both predictors serve it from disk on the CPU, and their
answers and request counters must agree.  The msgpack decoder is held
against ``flax.serialization.msgpack_restore``.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu import models as jmodels
from dt_tpu import optim
from dt_tpu.predictor import Predictor as JaxPredictor
from dt_tpu.training import checkpoint as jckpt
from dt_tpu.training.train_state import TrainState
from dt_tpu_torch import models as tmodels
from dt_tpu_torch.interchange import load_jax_variables
from dt_tpu_torch.predictor import Predictor
from dt_tpu_torch.training import checkpoint as tckpt
from dt_tpu_torch.utils import msgpack
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

BUCKETS = (1, 2, 4, 8)
ROW = (8, 8, 3)
TOL = 1e-4  # f32 logits; CPU convs sum in another order


def _variables(seed=1):
    model = jmodels.create("resnet20", num_classes=10)
    x = np.zeros((1,) + ROW, np.float32)
    shapes = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0)}, x,
                           training=False))
    rng = np.random.RandomState(seed)

    def one(path, s):
        k = path[-1].key
        if k == "mean":
            return rng.normal(0, 0.5, s.shape).astype(np.float32)
        if k == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return rng.normal(0, 0.3, s.shape).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(one, shapes)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    model, v = _variables()
    state = TrainState.create(model.apply, v["params"], optim.create("sgd"),
                              v["batch_stats"]).replace(step=jnp.int32(7))
    prefix = str(tmp_path_factory.mktemp("ckpt") / "r20")
    jckpt.save_checkpoint(prefix, 3, state, meta={"model": "resnet20"})
    sample = np.zeros((1,) + ROW, np.float32)
    jp = JaxPredictor("resnet20", prefix, 3, sample, batch_buckets=BUCKETS,
                      num_classes=10)
    tp = Predictor("resnet20", prefix, 3, sample, batch_buckets=BUCKETS,
                   device="cpu", num_classes=10)
    return prefix, v, jp, tp


def test_predictor_matches_jax_predictor(served):
    _, _, jp, tp = served
    assert tp.step == 7
    rng = np.random.RandomState(4)
    for n in (0, 1, 5, 19):
        x = rng.uniform(-1, 1, (n,) + ROW).astype(np.float32)
        want = np.asarray(jp.predict(x))
        got = tp.predict(x)
        assert got.shape == want.shape == (n, 10)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    keys = ("requests", "rows", "compiles")
    assert {k: tp.stats[k] for k in keys} == {k: jp.stats[k] for k in keys}
    assert tp.stats["requests"] == 4 and tp.stats["rows"] == 25
    p = tp.predict_proba(rng.uniform(-1, 1, (3,) + ROW).astype(np.float32))
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-6)


def test_warmup_counts_no_request(served):
    prefix, _, _, _ = served
    tp = Predictor("resnet20", prefix, 3, np.zeros((1,) + ROW, np.float32),
                   batch_buckets=BUCKETS, device="cpu", num_classes=10)
    with pytest.raises(ValueError, match="feature_shape"):
        tp.warmup()
    tp.warmup(ROW)
    assert tp.stats["requests"] == 0 and tp.stats["compiles"] == 0
    tp.predict(np.zeros((3,) + ROW, np.float32))
    assert tp.stats["compiles"] == 0  # bucket 4 was warmed


def test_swap_params_changes_answers(served):
    prefix, v, _, _ = served
    tp = Predictor("resnet20", prefix, 3, np.zeros((1,) + ROW, np.float32),
                   batch_buckets=BUCKETS, device="cpu", num_classes=10)
    x = np.random.RandomState(5).uniform(-1, 1, (4,) + ROW) \
        .astype(np.float32)
    before = tp.predict(x)
    new_params = jax.tree_util.tree_map(lambda a: np.asarray(a) * 1.5,
                                        v["params"])
    old_model = tp.model
    tp.swap_params(new_params)
    after = tp.predict(x)
    assert tp.model is not old_model
    assert not np.allclose(before, after)
    ref = tmodels.create("resnet20", device="cpu", num_classes=10)
    load_jax_variables(ref, {"params": new_params,
                             "batch_stats": v["batch_stats"]})
    with torch.no_grad():
        want = ref(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(after, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(old_model(torch.from_numpy(x).permute(
        0, 3, 1, 2)).detach().numpy(), before, rtol=1e-6, atol=1e-6)


def test_corrupt_state_file_raises(served, tmp_path):
    prefix, _, _, _ = served
    src = f"{prefix}-0003.state"
    dst_prefix = str(tmp_path / "r20")
    blob = bytearray(open(src, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(f"{dst_prefix}-0003.state", "wb") as f:
        f.write(blob)
    with open(f"{dst_prefix}-meta.json", "w") as f:
        f.write(open(f"{prefix}-meta.json").read())
    with pytest.raises(tckpt.CheckpointCorruptError, match="0003.state"):
        tckpt.load_checkpoint(dst_prefix, 3)
    with pytest.raises(tckpt.CheckpointCorruptError, match="0003.state"):
        Predictor("resnet20", dst_prefix, 3, np.zeros((1,) + ROW),
                  device="cpu", num_classes=10)
    with open(f"{dst_prefix}-0004.state", "wb") as f:
        f.write(bytes(blob[:100]))
    with pytest.raises(tckpt.CheckpointCorruptError, match="msgpack"):
        tckpt.load_checkpoint(dst_prefix, 4)
    open(f"{dst_prefix}-0005.state", "wb").close()
    with pytest.raises(tckpt.CheckpointCorruptError, match="zero-byte"):
        tckpt.load_checkpoint(dst_prefix, 5)
    assert tckpt.latest_checkpoint(dst_prefix) == 4
    assert tckpt.latest_checkpoint(dst_prefix) == \
        jckpt.latest_checkpoint(dst_prefix)


def test_meta_readers_match_jax(served):
    prefix, _, _, _ = served
    assert tckpt.read_meta(prefix) == jckpt.read_meta(prefix)
    assert tckpt.checkpoint_info(prefix, 3) == jckpt.checkpoint_info(prefix, 3)
    assert tckpt.read_meta(prefix + "-none") == {}


def test_checkpoint_leaves_match_flax_restore(served):
    prefix, _, _, _ = served
    blob = open(f"{prefix}-0003.state", "rb").read()
    want = flax.serialization.msgpack_restore(blob)
    got = tckpt.load_checkpoint(prefix, 3)
    for coll in ("params", "batch_stats"):
        w = jax.tree_util.tree_leaves_with_path(want[coll])
        g = dict(jax.tree_util.tree_leaves_with_path(got[coll]))
        assert len(w) == len(g)
        for path, leaf in w:
            np.testing.assert_array_equal(g[path], leaf)


def _as_f32(tree):
    def one(a):
        if isinstance(a, torch.Tensor):
            return a.float().numpy()
        if isinstance(a, np.ndarray) and a.dtype == jnp.bfloat16:
            return a.astype(np.float32)
        return a
    return jax.tree_util.tree_map(one, tree)


def test_msgpack_decoder_matches_flax():
    rng = np.random.RandomState(6)
    tree = {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "bf16": jnp.asarray(rng.normal(size=(5, 2)), jnp.bfloat16),
        "i32": np.arange(-7, 70, dtype=np.int32).reshape(7, 11),
        "u8": np.arange(300, dtype=np.uint8)[:200],
        "big": rng.normal(size=(70000,)).astype(np.float32),
        "scalar_f32": np.float32(2.5),
        "scalar_i64": np.int64(-123456789012),
        "zero_d": np.asarray(3, np.int32),
        "nested": {"0": {"a": np.ones((0, 3), np.float32)}, "s": "text" * 20},
        "ints": [0, 1, 127, 128, 255, 256, 65536, 2 ** 33, -1, -33, -129,
                 -40000, -2 ** 40],
        "floats": [1.5, -0.0, float("inf")],
        "flags": [True, False, None],
        "c": complex(1.0, -2.0),
        "bytes": b"\x00\x01" * 200,
    }
    blob = flax.serialization.msgpack_serialize(tree)
    want = flax.serialization.msgpack_restore(blob)
    got = msgpack.restore(blob)
    assert isinstance(got["bf16"], torch.Tensor)
    assert got["bf16"].dtype == torch.bfloat16
    got, want = _as_f32(got), _as_f32(want)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for (pg, g), (pw, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves_with_path(want)):
        assert pg == pw
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w and type(g) is type(w), (pg, g, w)


def test_msgpack_decoder_rejects_what_it_cannot_read():
    chunked = flax.serialization.msgpack_serialize(
        {"__msgpack_chunked_array__": True, "shape": {"0": 1}})
    with pytest.raises(msgpack.MsgpackError, match="chunked"):
        msgpack.restore(chunked)
    with pytest.raises(msgpack.MsgpackError, match="ext code 9"):
        msgpack.restore(b"\xd4\x09\x00")
    with pytest.raises(msgpack.MsgpackError, match="truncated"):
        msgpack.restore(b"\x92\x01")
    with pytest.raises(msgpack.MsgpackError, match="trailing"):
        msgpack.restore(b"\x01\x02")


def test_from_fn_buckets_and_swap():
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)

    def fn(params, stats, x):
        assert stats == {} and x.shape[0] in (1, 2, 4)
        assert x.is_contiguous(memory_format=torch.channels_last)
        return x.mean(dim=(2, 3)) @ params

    p = Predictor.from_fn(fn, w, batch_buckets=(1, 2, 4), device="cpu")
    x = np.random.RandomState(7).normal(size=(7, 2, 2, 3)).astype(np.float32)
    want = x.mean(axis=(1, 2)) @ w.numpy()
    np.testing.assert_allclose(p.predict(x), want, rtol=1e-6)
    p.swap_params(w * 2)
    np.testing.assert_allclose(p.predict(x), 2 * want, rtol=1e-6)
    assert p.stats["requests"] == 2 and p.stats["rows"] == 14


def test_predictor_needs_a_gpu_unless_cpu_is_asked(served, monkeypatch):
    prefix, _, _, _ = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor("resnet20", prefix, 3, np.zeros((1,) + ROW),
                  num_classes=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.from_fn(lambda p, s, x: x, None)


def test_bf16_predictor_tracks_jax_bf16(served):
    """bf16 compute: conv/dense weights in bf16, BN math in f32 cast once,
    the input cast at the boundary; answers come back as float32."""
    prefix, _, _, _ = served
    sample = np.zeros((1,) + ROW, np.float32)
    jp = JaxPredictor("resnet20", prefix, 3, sample, dtype=jnp.bfloat16,
                      batch_buckets=(4,), num_classes=10)
    tp = Predictor("resnet20", prefix, 3, sample, dtype=torch.bfloat16,
                   batch_buckets=(4,), device="cpu", num_classes=10)
    x = np.random.RandomState(8).uniform(-1, 1, (4,) + ROW) \
        .astype(np.float32)
    want = np.asarray(jp.predict(x)).astype(np.float32)
    got = tp.predict(x)
    assert got.dtype == np.float32
    # one bf16 ulp is 2**-8 relative; the frameworks round at other points
    # through 20 layers, so allow a few ulps of the largest logit
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
