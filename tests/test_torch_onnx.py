"""``dt_tpu_torch.onnx`` against ``dt_tpu.onnx`` on the CPU.

- The protobuf codec writes the JAX package's bytes for the same input
  (tensors of every dtype, attributes, nodes, value infos, the model) and
  reads back packed and unpacked fields alike, over the cases of
  ``tests/test_onnx.py``.
- Files cross the packages both ways for ``tests/test_onnx.py``'s models
  and shapes: a file the JAX package exports from ``model.init`` weights
  runs on the port's importer, and a file the port exports from a port
  model holding the same weights (``load_jax_variables``) runs on the JAX
  importer, each within 1e-4 of ``model.apply`` (the JAX tests' own
  tolerance), and the port's file emits only ops the JAX importer reads.
  The JAX side runs jitted (``init``, ``apply``, the importer's ``fn``;
  eagerly it compiles op by op, ~5x slower).
- Unmapped ops refuse on both sides, with the JAX importer's message.
- ``Predictor.from_onnx`` serves on ``device="cpu"`` what the JAX
  ``Predictor.from_onnx`` serves (a non-float32 ``dtype`` gives the same
  result or the same error), and a replica serves a file end to end, as
  ``tests/test_serve.py``'s ``test_from_onnx_replica_e2e`` does.
"""

import inspect
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu import models as jmodels
from dt_tpu import onnx as jonnx
from dt_tpu.predictor import Predictor as JPredictor
from dt_tpu_torch import models as tmodels
from dt_tpu_torch import onnx as tonnx
from dt_tpu_torch.elastic.scheduler import Scheduler
from dt_tpu_torch.interchange import load_jax_variables
from dt_tpu_torch.predictor import Predictor
from dt_tpu_torch.serve import InferClient
from dt_tpu_torch.serve.replica import Replica, params_for_step
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

TOL = 1e-4  # tests/test_onnx.py's round trips

#: (name, input shape, kwargs) of tests/test_onnx.py's round trips
MODELS = [
    ("mlp", (4, 6, 6, 1), {"num_classes": 5, "hidden": (16, 8)}),
    ("lenet", (2, 28, 28, 1), {"num_classes": 4}),
    ("resnet18", (1, 32, 32, 3), {"num_classes": 3}),
    ("transformer_lm", (2, 12), {"vocab_size": 50, "num_layers": 1,
                                 "embed_dim": 16, "num_heads": 2,
                                 "max_len": 12}),
    ("alexnet", (1, 64, 64, 3), {"num_classes": 4}),
    ("mobilenet", (1, 32, 32, 3), {"num_classes": 4}),
    ("squeezenet", (1, 64, 64, 3), {"num_classes": 4}),
    ("resnet18_v2", (1, 32, 32, 3), {"num_classes": 4}),
]
_IDS = [m[0] for m in MODELS]

#: every op the JAX importer's ``_run_node`` reads
JAX_IMPORTER_OPS = set(re.findall(r'"([A-Z][A-Za-z]+)"',
                                  inspect.getsource(jonnx._run_node)))

_CACHE = {}


def _case(name):
    """The JAX model, its variables, the input and ``model.apply``'s output
    (computed once a module)."""
    if name not in _CACHE:
        _, shape, kw = next(m for m in MODELS if m[0] == name)
        rng = np.random.RandomState(0)
        if len(shape) == 2:
            x = rng.randint(0, kw["vocab_size"], shape).astype(np.int32)
        else:
            x = rng.uniform(-1, 1, shape).astype(np.float32)
        model = jmodels.create(name, **kw)
        # jitted: eager flax compiles op by op, ~5x slower
        variables = jax.jit(lambda k, x: model.init(
            {"params": k}, x, training=False))(jax.random.PRNGKey(0),
                                               jnp.asarray(x))
        want = np.asarray(jax.jit(lambda v, x: model.apply(
            v, x, training=False))(variables, jnp.asarray(x)))
        _CACHE[name] = (model, variables, x, want)
    return _CACHE[name]


def _port_model(name, shape, kw):
    kw = dict(kw)
    if name == "mlp":
        kw["in_shape"] = shape[1:]
    if tmodels.takes_image_size(name):  # AlexNet: a flat width from the side
        kw["image_size"] = shape[1:3]
    return tmodels.create(name, device="cpu", **kw)


# --- the codec --------------------------------------------------------------

def test_codec_tensors_bytes_equal():
    """``tests/test_onnx.py``'s fuzz: every supported dtype, 0-d, empty and
    larger shapes; the bytes equal and each side parses the other's."""
    rng = np.random.RandomState(0)
    for i in range(40):
        dt = rng.choice([np.float32, np.uint8, np.int8, np.int32,
                         np.int64, np.bool_, np.float16, np.float64])
        nd = rng.randint(0, 4)
        shape = tuple(int(s) for s in rng.randint(0, 6, nd))
        if dt == np.bool_:
            arr = rng.rand(*shape) > 0.5
        elif np.issubdtype(dt, np.floating):
            arr = rng.normal(0, 1e3, shape).astype(dt)
        else:
            info = np.iinfo(dt)
            arr = rng.randint(max(info.min, -2**31), min(info.max, 2**31 - 1),
                              shape).astype(dt)
        name = f"t{i}"
        blob = tonnx._tensor_proto(name, arr)
        assert blob == jonnx._tensor_proto(name, arr)
        got_name, got = tonnx._parse_tensor(blob)
        assert got_name == name and got.dtype == arr.dtype
        assert got.shape == arr.shape
        np.testing.assert_array_equal(got, arr)


def test_codec_attrs_nodes_and_value_infos_bytes_equal():
    cases = [("i", -(2**40)), ("i2", 2**40), ("f", 3.25),
             ("s", "hello/世界"), ("ints", [1, -2, 3]), ("empty", []),
             ("floats", [0.5, -1.25]), ("npf", [np.float32(0.5)]),
             ("b", True), ("t", np.arange(6, dtype=np.float32))]
    for name, val in cases:
        blob = tonnx._attr(name, val)
        assert blob == jonnx._attr(name, val)
        jn, jv = jonnx._parse_attr(blob)
        tn, tv = tonnx._parse_attr(blob)
        assert jn == tn == name
        if isinstance(jv, np.ndarray):
            np.testing.assert_array_equal(jv, tv)
        else:
            assert jv == tv
    with pytest.raises(TypeError):
        tonnx._attr("bad", object())
    kw = dict(strides=[2, 2], group=3, pads=[0, 1, 0, 1])
    blob = tonnx._node("Conv", ["a", "b"], ["y"], name="n0", **kw)
    assert blob == jonnx._node("Conv", ["a", "b"], ["y"], name="n0", **kw)
    assert tonnx._parse_node(blob) == jonnx._parse_node(blob)
    for shape, dt in [((1, 28, 28, 1), np.float32), ((2, 12), np.int32),
                      ((), np.float64)]:
        vi = tonnx._value_info("input_0", shape, dt)
        assert vi == jonnx._value_info("input_0", shape, dt)
        assert tonnx._parse_value_info(vi) == jonnx._parse_value_info(vi)
    assert tonnx._model_proto(b"g", 13) == jonnx._model_proto(b"g", 13)
    for n in (0, 1, 127, 128, 300, 2**63 - 1, -1, -7):
        assert tonnx._varint(n) == jonnx._varint(n)


def test_codec_packed_repeated_fields():
    """Packed dims, ints, floats and negative int64s, as proto3 serializers
    write them, parse alike on both sides."""
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    packed_dims = b"".join(tonnx._varint(d) for d in arr.shape)
    blob = (tonnx._len_delim(1, packed_dims)
            + tonnx._int_field(2, tonnx._DT_FLOAT)
            + tonnx._str_field(8, "pt") + tonnx._len_delim(9, arr.tobytes()))
    name, got = tonnx._parse_tensor(blob)
    assert name == "pt"
    np.testing.assert_array_equal(got, arr)
    blobs = [
        tonnx._str_field(1, "perm") + tonnx._len_delim(
            8, b"".join(tonnx._varint(v) for v in [0, 3, 1, 2])),
        tonnx._str_field(1, "scales") + tonnx._len_delim(
            7, np.asarray([0.5, -1.25, 3.0], "<f4").tobytes()),
        tonnx._str_field(1, "neg") + tonnx._len_delim(
            8, b"".join(tonnx._varint(v & ((1 << 64) - 1))
                        for v in [-1, -7]))]
    for b in blobs:
        assert tonnx._parse_attr(b) == jonnx._parse_attr(b)
    assert tonnx._parse_attr(blobs[2])[1] == [-1, -7]


# --- files crossing the packages ------------------------------------------

@pytest.mark.parametrize("name,shape,kw", MODELS, ids=_IDS)
def test_jax_file_runs_on_the_port(name, shape, kw):
    model, variables, x, want = _case(name)
    blob = jonnx.export_onnx(model, jnp.asarray(x), variables=variables)
    fn, params = tonnx.import_onnx(blob)
    assert set(params) == set(jonnx.parse_model(blob)["initializers"])
    got = fn(params, x)
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name,shape,kw", MODELS, ids=_IDS)
def test_port_file_runs_on_jax(name, shape, kw, tmp_path):
    model, variables, x, want = _case(name)
    port = load_jax_variables(_port_model(name, shape, kw),
                              jax.tree_util.tree_map(np.asarray,
                                                     dict(variables)))
    path = str(tmp_path / f"{name}.onnx")
    blob = tonnx.export_onnx(port, x, path=path)
    assert open(path, "rb").read() == blob
    m = tonnx.parse_model(blob)
    jm = jonnx.parse_model(blob)  # both parsers read the same graph
    assert [m[k] for k in ("nodes", "inputs", "outputs", "opset")] == \
        [jm[k] for k in ("nodes", "inputs", "outputs", "opset")]
    assert m["initializers"].keys() == jm["initializers"].keys()
    for k, a in m["initializers"].items():
        np.testing.assert_array_equal(a, jm["initializers"][k])
    ops = {n["op_type"] for n in m["nodes"]}
    assert ops <= JAX_IMPORTER_OPS, sorted(ops - JAX_IMPORTER_OPS)
    # the interface of the JAX export: NHWC (or token) input at the
    # example's batch, one output, the weights as initializers
    assert [(n, s) for n, s, _ in m["inputs"]] == [("input_0", shape)]
    assert [s for _, s, _ in m["outputs"]] == [want.shape]
    n_weights = sum(p.numel() for p in port.parameters())
    assert sum(a.size for a in m["initializers"].values()) >= n_weights
    fn, params = jonnx.import_onnx(path)
    got = np.asarray(jax.jit(fn)(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # and the port reads its own file back
    tfn, tparams = tonnx.import_onnx(blob)
    np.testing.assert_allclose(tfn(tparams, x).numpy(), want, rtol=TOL,
                               atol=TOL)


def test_port_export_batches_and_structure():
    """Shapes are baked at the example's batch; the graph is well formed
    (every node input an initializer, a graph input or an earlier output)
    and carries the JAX export's producer and opset."""
    port = _port_model("lenet", (3, 28, 28, 1), {"num_classes": 4})
    x = np.zeros((3, 28, 28, 1), np.float32)
    m = tonnx.parse_model(tonnx.export_onnx(port, x, opset=13))
    assert m["opset"] == 13 and m["inputs"][0][1] == (3, 28, 28, 1)
    assert m["outputs"][0][1] == (3, 4)
    ops = {n["op_type"] for n in m["nodes"]}
    assert {"Conv", "MatMul", "MaxPool"} <= ops
    known = set(m["initializers"]) | {n for n, _, _ in m["inputs"]}
    for node in m["nodes"]:
        for nm in node["input"]:
            assert not nm or nm in known, f"dangling input {nm}"
        known.update(node["output"])


def test_port_export_of_a_callable_and_its_ops():
    """A plain callable exports with its inputs as given: a product, a
    mean, a slice, a clamp, a concat and a softmax, run by the JAX
    importer."""
    w = np.random.RandomState(1).normal(0, 1, (6, 5)).astype(np.float32)
    wt = torch.from_numpy(w)

    def f(x):
        y = x @ wt
        z = torch.cat([y.mean(dim=1, keepdim=True), y[:, 1:4]], dim=1)
        return torch.softmax(torch.clamp(z, -0.5, 0.7), dim=-1)

    x = np.random.RandomState(2).normal(0, 1, (3, 6)).astype(np.float32)
    blob = tonnx.export_onnx(f, x)
    fn, params = jonnx.import_onnx(blob)
    want = f(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(fn(params, jnp.asarray(x))), want,
                               rtol=1e-6, atol=1e-6)
    ops = {n["op_type"] for n in tonnx.parse_model(blob)["nodes"]}
    assert {"MatMul", "ReduceSum", "Slice", "Concat", "Softmax"} <= ops
    assert ops <= JAX_IMPORTER_OPS


def test_unmapped_ops_refuse():
    with pytest.raises(NotImplementedError, match="aten.cumsum"):
        tonnx.export_onnx(lambda x: torch.cumsum(x, 0),
                          np.ones((4,), np.float32))
    deconv = torch.nn.ConvTranspose2d(2, 3, 3)
    with pytest.raises(NotImplementedError, match="transposed"):
        tonnx.export_onnx(lambda x: deconv(x), np.ones((1, 2, 5, 5),
                                                       np.float32))
    node = tonnx._node("NoSuchOp", ["x"], ["y"])
    blob = tonnx._model_proto(
        tonnx._len_delim(1, node)
        + tonnx._len_delim(11, tonnx._value_info("x", (2,), np.float32))
        + tonnx._len_delim(12, tonnx._value_info("y", (2,), np.float32)), 13)
    for lib in (jonnx, tonnx):
        fn, params = lib.import_onnx(blob)
        with pytest.raises(NotImplementedError,
                           match="ONNX import: unsupported op NoSuchOp"):
            fn(params, np.ones(2, np.float32))


def test_importer_semantics_match_jax():
    """Asymmetric pads on Conv and MaxPool (an explicit pad, -inf for the
    max), AveragePool with and without ``count_include_pad``, a Pad of a
    constant, Gather of negative indices, a strided Slice, Split, Where with
    a float64 constant, ReduceProd, ArgMax and Cast, on both importers."""
    g = tonnx._Graph()
    rng = np.random.RandomState(3)
    x = rng.normal(0, 1, (2, 3, 7, 6)).astype(np.float32)
    w = g.const(rng.normal(0, 1, (4, 3, 3, 2)).astype(np.float32), "w")
    outs = []
    y = g.add("Conv", ["x", w], strides=[2, 1], pads=[0, 1, 2, 0])[0]
    outs.append(y)
    outs.append(g.add("MaxPool", ["x"], kernel_shape=[3, 2], strides=[2, 2],
                      pads=[1, 0, 0, 1])[0])
    for inc in (0, 1):
        outs.append(g.add("AveragePool", ["x"], kernel_shape=[3, 3],
                          strides=[1, 2], pads=[1, 1, 2, 0],
                          count_include_pad=inc)[0])
    outs.append(g.add("Pad", ["x", g.const(np.asarray(
        [0, 0, 1, 2, 0, 1, 0, 1], np.int64)), g.const(np.asarray(
            1.5, np.float32))])[0])
    outs.append(g.add("Gather", ["x", g.const(np.asarray([-1, 0, 2],
                                                         np.int64))],
                      axis=3)[0])
    outs.append(g.add("Slice", ["x", g.const(np.asarray([1, -1], np.int64)),
                                g.const(np.asarray([7, -7], np.int64)),
                                g.const(np.asarray([2, 3], np.int64)),
                                g.const(np.asarray([2, -2], np.int64))])[0])
    outs += g.add("Split", ["x", g.const(np.asarray([2, 5], np.int64))],
                  n_out=2, axis=2)
    lt = g.add("Less", ["x", g.const(np.asarray(0.1, np.float64))])[0]
    outs.append(g.add("Where", [lt, "x", g.const(np.asarray(
        -2.0, np.float64))])[0])
    outs.append(g.add("ReduceProd", ["x"], axes=[1, 3], keepdims=0)[0])
    outs.append(g.add("ArgMax", ["x"], axis=2, keepdims=1)[0])
    outs.append(g.add("Cast", ["x"], to=tonnx._DT_INT32)[0])
    graph = b"".join(tonnx._len_delim(1, n) for n in g.nodes)
    graph += b"".join(tonnx._len_delim(5, t) for t in g.initializers)
    graph += tonnx._len_delim(11, tonnx._value_info("x", x.shape,
                                                    np.float32))
    graph += b"".join(tonnx._len_delim(12, tonnx._value_info(
        o, (), np.float32)) for o in outs)
    blob = tonnx._model_proto(graph, 13)
    jfn, jp = jonnx.import_onnx(blob)
    tfn, tp = tonnx.import_onnx(blob)
    want = jfn(jp, jnp.asarray(x))
    got = tfn(tp, x)
    assert len(got) == len(want) == len(outs)
    for i, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape), (i, a.shape, tuple(b.shape))
        np.testing.assert_allclose(b.numpy().astype(np.float64), a,
                                   rtol=1e-6, atol=1e-6, err_msg=str(i))


# --- serving ------------------------------------------------------------

def test_predictor_from_onnx_on_the_cpu():
    """The JAX file of LeNet (its shapes baked at batch 2) served by both
    packages' ``from_onnx`` at bucket 2 (a request of 5: split and the
    last chunk padded), and
    the non-float32 ``dtype`` rule: bfloat16 requests of a conv graph are
    a ``TypeError`` in both (lax's convolution takes one dtype), of a dense
    graph a float32 result in both (promoted to the weights' type)."""
    model, variables, x, _ = _case("lenet")
    blob = jonnx.export_onnx(model, jnp.asarray(x), variables=variables)
    req = np.random.RandomState(4).uniform(-1, 1, (5, 28, 28, 1)) \
        .astype(np.float32)
    jp = JPredictor.from_onnx(blob, batch_buckets=[2])
    tp = Predictor.from_onnx(blob, batch_buckets=[2], device="cpu")
    want = jp.predict(req)
    got = tp.predict(req)
    assert got.dtype == np.float32 and got.shape == (5, 4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert tp.stats["requests"] == 1 and tp.stats["rows"] == 5
    with pytest.raises(TypeError, match="same dtype"):
        JPredictor.from_onnx(blob, dtype=jnp.bfloat16,
                             batch_buckets=[2]).predict(req)
    with pytest.raises(TypeError, match="one dtype"):
        Predictor.from_onnx(blob, dtype=torch.bfloat16, batch_buckets=[2],
                            device="cpu").predict(req)
    mlp, mvars, mx, _ = _case("mlp")
    mblob = jonnx.export_onnx(mlp, jnp.asarray(mx), variables=mvars)
    want = JPredictor.from_onnx(mblob, dtype=jnp.bfloat16,
                                batch_buckets=[4]).predict(mx)
    got = Predictor.from_onnx(mblob, dtype=torch.bfloat16, batch_buckets=[4],
                              device="cpu").predict(mx)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(RuntimeError, match="no CUDA device") if \
            not torch.cuda.is_available() else _no_error():
        Predictor.from_onnx(blob)  # the card by default, no fallback


class _no_error:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_from_onnx_replica_e2e(tmp_path):
    """A replica serving a JAX-exported file (``x @ w``) through the port's
    scheduler and client, as ``tests/test_serve.py`` does for the JAX
    package."""
    features, classes = 4, 3
    w = params_for_step(features, classes, 0)["w"]
    blob = jonnx.export_onnx(lambda x: x @ w,
                             jnp.ones((2, features), jnp.float32))
    pred = Predictor.from_onnx(blob, max_batch=8, device="cpu")
    sched = Scheduler(initial_workers=[],
                      host_worker_file=str(tmp_path / "hosts"))
    rep = None
    try:
        rep = Replica(pred, "onnx0", f"127.0.0.1:{sched.port}",
                      heartbeat_s=0.1, advertise_host="127.0.0.1")
        c = InferClient(scheduler=f"127.0.0.1:{sched.port}")
        deadline = time.time() + 10
        while not c.refresh_endpoints():
            assert time.time() < deadline
            time.sleep(0.05)
        x = np.random.RandomState(3).randn(5, features).astype(np.float32)
        out = c.infer(x)
        np.testing.assert_allclose(out["y"], x @ w, rtol=1e-5)
    finally:
        if rep is not None:
            rep.close()
        sched.close()
