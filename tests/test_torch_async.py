"""``dist_async`` in the port against the JAX package, on the CPU.

- One script of ``set_optimizer``, ``async_init``, ``async_push`` (dense and
  row-sparse, a replayed seq, a stale seq, before init, adam's refused
  sparse update), ``async_stats``, ``async_pull_rows``, a row-sparse
  allreduce round and the range-server registry, sent through the JAX
  package's wire to each package's scheduler: the replies' pickled bytes
  equal.
- A one-worker ``Module.fit(kvstore="dist_async")`` of the digits MLP and of
  the JAX harness's ``TinyBNNet``, port (its own scheduler) against JAX
  (its own): per-epoch train cross-entropy within 1e-5 relative, the
  masters within 1e-5 of their largest value.
- A JAX worker and a port worker pushing in lock-step (the test alternates
  them, so the order is fixed) against each scheduler: the master bit for
  bit the all-JAX run's.  Each worker's gradient is the JAX function's of
  its own params; the port worker takes it through the port's flat layout,
  client and adoption (``Module._adopt_master``), so a flat order or
  layout that differs from JAX's ravel would show.
- ``Trainer`` with two workers over ``dist_async`` (lock-step) and over
  ``tpu_sync`` (overlapped and serial), port against JAX: ``dist_async`` bit
  for bit, ``tpu_sync`` within 1e-6 (the two SGDs' rounding), the workers
  and the two sync modes bit-identical.
- The halt over ``dist_async``: a NaN batch under ``DT_HEALTH_HALT=1``
  withholds the push in both packages, the masters equal within 1e-6.
"""

import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from dt_tpu.data import io as jio
from dt_tpu.elastic import Scheduler as JScheduler
from dt_tpu.elastic import WorkerClient as JClient
from dt_tpu.elastic import protocol as jproto
from dt_tpu.parallel import kvstore as jkv
from dt_tpu.training.module import Module as JModule
from dt_tpu.training.trainer import Trainer as JTrainer
from dt_tpu_torch import models as tmodels
from dt_tpu_torch.data import io as tio
from dt_tpu_torch.elastic.client import WorkerClient as TClient
from dt_tpu_torch.elastic.scheduler import Scheduler as TScheduler
from dt_tpu_torch.interchange import export_jax_variables, load_jax_variables
from dt_tpu_torch.parallel import kvstore as tkv
from dt_tpu_torch.training.module import Module as TModule
from dt_tpu_torch.training.trainer import Trainer as TTrainer
from test_torch_elastic_mixed_ref import jax_worker_module
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

SGD = {"name": "sgd", "learning_rate": 0.1, "momentum": 0.9,
       "weight_decay": 1e-4}
#: port against JAX over a one-worker fit: losses and master
TOL_FIT = 1e-5
#: thread joins and requests: a hang fails the test
DEADLINE = 60


def _same_bytes(a, b) -> bool:
    return pickle.dumps(a, protocol=5) == pickle.dumps(b, protocol=5)


def _parallel(fns):
    out, errs = [None] * len(fns), []

    def run(i):
        try:
            out[i] = fns[i]()
        except Exception as e:  # noqa: BLE001 — raised below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(DEADLINE)
    assert not any(t.is_alive() for t in ts), "a thread hung"
    if errs:
        raise errs[0]
    return out


# ---------------------------------------------------------------------------
# the wire: replies byte for byte
# ---------------------------------------------------------------------------


def _script(cls):
    sched = cls(initial_workers=["w0", "w1"])
    rng = np.random.RandomState(0)
    log = []

    def req(label, msg):
        log.append((label, jproto.request("127.0.0.1", sched.port, msg,
                                          timeout=DEADLINE)))

    def push(label, host, key, seq, value):
        req(label, {"cmd": "async_push", "host": host, "key": key,
                    "seq": seq, "value": value})

    try:
        for h in ("w0", "w1"):
            req(f"register {h}", {"cmd": "register", "host": h,
                                  "is_new": False, "is_recovery": False})
        g = [rng.normal(size=(6, 5)).astype(np.float32) for _ in range(4)]
        push("push before set_optimizer", "w0", "p", 0, g[0])
        req("bad spec", {"cmd": "set_optimizer", "spec": {"name": "ftrl"}})
        req("bad kwarg", {"cmd": "set_optimizer",
                          "spec": {"name": "sgd", "rho": 0.5}})
        req("set_optimizer", {"cmd": "set_optimizer", "spec": SGD})
        req("set_optimizer again", {"cmd": "set_optimizer", "spec": SGD})
        push("push before init", "w0", "p", 0, g[0])
        w0 = rng.normal(size=(6, 5)).astype(np.float32)
        req("init", {"cmd": "async_init", "key": "p", "value": w0})
        req("init again", {"cmd": "async_init", "key": "p",
                           "value": w0 + 1})
        push("w0 seq 0", "w0", "p", 0, g[0])
        push("w1 seq 0", "w1", "p", 0, g[1])
        push("w0 seq 0 replayed", "w0", "p", 0, g[2])
        push("w0 seq 1", "w0", "p", 1, g[2])
        push("w1 seq 1", "w1", "p", 1, g[3])
        push("w0 seq 0 stale", "w0", "p", 0, g[3])
        table = rng.normal(size=(9, 3)).astype(np.float32)
        req("init emb", {"cmd": "async_init", "key": "emb", "value": table})
        ids = np.array([4, 1, 4, 8, 11])  # a duplicate, one past the table
        vals = rng.normal(size=(5, 3)).astype(np.float32)
        push("sparse w0", "w0", "emb", 0, {"ids": ids, "vals": vals})
        push("sparse w1", "w1", "emb", 0, {"ids": ids[:2], "vals": vals[:2]})
        push("sparse w0 replayed", "w0", "emb", 0, {"ids": ids[:1],
                                                    "vals": vals[:1]})
        req("stats", {"cmd": "async_stats"})
        req("pull rows", {"cmd": "async_pull_rows", "key": "emb",
                          "ids": np.array([0, 4, 99, -1])})
        req("pull unknown", {"cmd": "async_pull_rows", "key": "nope",
                             "ids": np.array([0])})
        rs = [{"ids": np.array([0, 6, 6], np.int32),
               "vals": rng.normal(size=(3, 2)).astype(np.float32),
               "num_rows": 7} for _ in range(2)]
        log.append(("sparse allreduce", _parallel([
            lambda i=i, h=h: jproto.request(
                "127.0.0.1", sched.port,
                {"cmd": "allreduce", "host": h, "key": "se", "seq": 0,
                 "value": rs[i]}, timeout=DEADLINE)
            for i, h in enumerate(("w0", "w1"))])))
        req("adam", {"cmd": "set_optimizer",
                     "spec": {"name": "adam", "learning_rate": 0.01}})
        push("sparse under adam", "w0", "emb", 5, {"ids": ids,
                                                   "vals": vals})
        push("dense under adam", "w1", "p", 7, g[0])
        req("register_server", {"cmd": "register_server", "index": 1,
                                "host": "127.0.0.1", "port": 1234})
        req("register_server 0", {"cmd": "register_server", "index": 0,
                                  "host": "127.0.0.1", "port": 1233})
        req("servers", {"cmd": "servers"})
        req("register w2", {"cmd": "register", "host": "w2",
                            "is_new": True, "is_recovery": False})
        store = {k: np.array(v) for k, v in sched._async_store.items()}
    finally:
        sched.close()
    return log, store


def test_async_replies_match_the_jax_scheduler_byte_for_byte():
    ref, ref_store = _script(JScheduler)
    port, port_store = _script(TScheduler)
    assert [lb for lb, _ in ref] == [lb for lb, _ in port]
    for (label, r), (_, p) in zip(ref, port):
        assert _same_bytes(r, p), (label, r, p)
    assert ref_store.keys() == port_store.keys() == {"p", "emb"}
    for k in ref_store:
        assert ref_store[k].tobytes() == port_store[k].tobytes()
    errors = [lb for lb, r in port if "error" in r]
    assert errors == ["push before set_optimizer", "bad spec", "bad kwarg",
                      "push before init", "pull unknown",
                      "sparse under adam"]


# ---------------------------------------------------------------------------
# one worker's Module.fit, port against JAX
# ---------------------------------------------------------------------------


def _digits(n=512):
    from sklearn.datasets import load_digits
    d = load_digits()
    x = (d.images[..., None] / 16.0).astype(np.float32)
    return x[:n], d.target[:n].astype(np.int32)


def _fit_case(name):
    """(JAX model, port model, x, y, batch) of a fit case."""
    if name == "mlp":
        x, y = _digits()
        return (None, tmodels.create("mlp", device="cpu", in_shape=(8, 8, 1),
                                     num_classes=10), x, y, 64)
    import torch_elastic_worker as tw
    ew = jax_worker_module()
    x, y = ew.make_dataset()
    return ew.TinyBNNet.create(), tw.TinyBNNet(), x, y, 32


def _fit_async(pkg, name, epochs=2):
    """One worker's fit over dist_async against its own package's
    scheduler: (per-epoch ce, master)."""
    import dt_tpu.models as jmodels
    jmodel, tmodel, x, y, batch = _fit_case(name)
    if jmodel is None:
        jmodel = jmodels.create("mlp", num_classes=10)
    sched = (JScheduler if pkg == "jax" else TScheduler)(
        initial_workers=["w0"])
    ctrl = (JClient if pkg == "jax" else TClient)(
        "127.0.0.1", sched.port, host="w0", heartbeat_interval_s=0.5)
    spec = {k: v for k, v in SGD.items() if k != "name"}
    try:
        jmod = JModule(jmodel, optimizer="sgd", optimizer_params=spec,
                       seed=7)
        jmod.init_params(x[:batch])
        if pkg == "jax":
            kv = jkv.create("dist_async")
            kv.set_controller(ctrl)
            mod = JModule(jmodel, optimizer="sgd", optimizer_params=spec,
                          kvstore=kv, seed=7)
            mod.init_params(x[:batch])
            io = jio
        else:
            kv = tkv.create("dist_async")
            kv.set_controller(ctrl)
            mod = TModule(tmodel, optimizer="sgd", optimizer_params=spec,
                          kvstore=kv, device="cpu")
            mod.init_params()
            load_jax_variables(mod.model, {
                "params": jax.device_get(jmod.state.params),
                "batch_stats": jax.device_get(jmod.state.batch_stats)})
            io = tio
        ce = []
        mod.fit(io.NDArrayIter(x, y, batch_size=batch), eval_metric="ce",
                num_epoch=epochs, epoch_end_callback=lambda e, s, m: ce.append(
                    dict(m.get_name_value())["cross-entropy"]))
        master = np.array(sched._async_store["params"])
    finally:
        ctrl.close()
        sched.close()
    return ce, master, mod


@pytest.mark.parametrize("name", ["mlp", "tinybn"])
def test_one_worker_dist_async_fit_matches_the_jax_module(name):
    jce, jmaster, jmod = _fit_async("jax", name)
    tce, tmaster, tmod = _fit_async("port", name)
    assert len(tce) == len(jce) == 2
    for a, b in zip(tce, jce):
        assert abs(a - b) <= TOL_FIT * abs(b), (tce, jce)
    assert tmaster.shape == jmaster.shape
    err = np.abs(tmaster - jmaster).max() / np.abs(jmaster).max()
    assert err <= TOL_FIT, err
    # the worker holds the master it was answered last, in its own layout
    lay = tmod.state.layout.params
    np.testing.assert_array_equal(lay.ravel(tmod.state.params).numpy(),
                                  tmaster)
    assert tmod.state.step == jmod.state.step == 16


# ---------------------------------------------------------------------------
# a JAX worker and a port worker in lock-step
# ---------------------------------------------------------------------------


def _lockstep(sched_cls, port_second: bool, steps=6):
    """Two workers of the JAX harness's TinyBNNet push in turn; worker 1
    is a port worker when ``port_second``.  Returns the final master."""
    ew = jax_worker_module()
    import torch_elastic_worker as tw
    net = ew.TinyBNNet.create()
    x, y = ew.make_dataset()
    variables = net.init(jax.random.PRNGKey(7), x[:16], training=False)
    stats = variables["batch_stats"]

    @jax.jit
    def grad(params, xb, yb):
        def loss(p):
            logits, _ = net.apply({"params": p, "batch_stats": stats}, xb,
                                  training=True, mutable=["batch_stats"])
            logp = jax.nn.log_softmax(logits)
            return -jnp.mean(logp[jnp.arange(xb.shape[0]), yb])
        return jax.grad(loss)(params)

    sched = sched_cls(initial_workers=["w0", "w1"])
    ctrls = [JClient("127.0.0.1", sched.port, host="w0",
                     heartbeat_interval_s=0.5),
             (TClient if port_second else JClient)(
                 "127.0.0.1", sched.port, host="w1",
                 heartbeat_interval_s=0.5)]
    try:
        flat0, unravel = ravel_pytree(variables["params"])
        jkvs = jkv.create("dist_async")
        jkvs.set_controller(ctrls[0])
        p0 = unravel(jnp.asarray(jkvs.attach_flat(
            "params", SGD, np.asarray(flat0))))
        if port_second:
            kv = tkv.create("dist_async")
            kv.set_controller(ctrls[1])
            tmod = TModule(tw.TinyBNNet(), optimizer="sgd",
                           optimizer_params={k: v for k, v in SGD.items()
                                             if k != "name"},
                           kvstore=kv, device="cpu")
            tmod.init_params()
            load_jax_variables(tmod.model, jax.device_get(variables))
            tmod._attach_async()
            gmodel = tw.TinyBNNet()  # carries a gradient into port names
        else:
            kv = jkv.create("dist_async")
            kv.set_controller(ctrls[1])
            p1 = unravel(jnp.asarray(kv.attach_flat("params", SGD,
                                                    np.asarray(flat0))))
        for k in range(steps):
            xb, yb = x[k * 16:(k + 1) * 16], y[k * 16:(k + 1) * 16]
            if k % 2 == 0:
                g = grad(p0, xb, yb)
                p0 = unravel(jnp.asarray(jkvs.push_flat(
                    "params", np.asarray(ravel_pytree(g)[0]))))
            elif port_second:
                params = export_jax_variables(tmod.model)["params"]
                g = grad(jax.tree_util.tree_map(jnp.asarray, params), xb, yb)
                load_jax_variables(gmodel, {
                    "params": jax.device_get(g),
                    "batch_stats": jax.device_get(stats)})
                flat_g = tmod.state.layout.params.ravel(
                    dict(gmodel.named_parameters())).numpy()
                tmod._adopt_master(kv.push_flat("params", flat_g))
            else:
                g = grad(p1, xb, yb)
                p1 = unravel(jnp.asarray(kv.push_flat(
                    "params", np.asarray(ravel_pytree(g)[0]))))
        return np.array(sched._async_store["params"])
    finally:
        for c in ctrls:
            c.close()
        sched.close()


@pytest.mark.parametrize("sched_cls", [JScheduler, TScheduler],
                         ids=["jax_scheduler", "port_scheduler"])
def test_jax_and_port_workers_in_lockstep_share_one_master(sched_cls):
    ref = _lockstep(JScheduler, port_second=False)
    mixed = _lockstep(sched_cls, port_second=True)
    assert mixed.tobytes() == ref.tobytes()


# ---------------------------------------------------------------------------
# Trainer with two workers
# ---------------------------------------------------------------------------


def _trainer_grads(k, i):
    rng = np.random.RandomState(100 + 10 * k + i)
    return {"Dense_0": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                        "bias": rng.normal(size=3).astype(np.float32)},
            "Conv_0": {"kernel": rng.normal(size=(2, 2, 1, 2))
                       .astype(np.float32)}}


def _trainer_params():
    rng = np.random.RandomState(1)
    return {"Dense_0": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                        "bias": np.zeros(3, np.float32)},
            "Conv_0": {"kernel": rng.normal(size=(2, 2, 1, 2))
                       .astype(np.float32)}}


def _trainers(pkg, store, steps=4, overlap="1", monkeypatch=None):
    """Two Trainers (workers w0, w1) of ``pkg`` against its scheduler;
    ``tpu_sync`` steps run both at once, ``dist_async`` ones alternate.
    Returns each worker's final params as flat numpy (sorted paths)."""
    if monkeypatch is not None:
        monkeypatch.setenv("DT_AR_OVERLAP", overlap)
    sched = (JScheduler if pkg == "jax" else TScheduler)(
        initial_workers=["w0", "w1"])
    ctrls = [(JClient if pkg == "jax" else TClient)(
        "127.0.0.1", sched.port, host=h, heartbeat_interval_s=0.5)
        for h in ("w0", "w1")]
    spec = {"learning_rate": 0.1, "momentum": 0.9}
    try:
        trainers = []
        for c in ctrls:
            kv = (jkv if pkg == "jax" else tkv).create(store)
            kv.set_controller(c)
            p = _trainer_params()
            if pkg == "jax":
                p = jax.tree_util.tree_map(jnp.asarray, p)
                trainers.append(JTrainer(p, "sgd", spec, kvstore=kv))
            else:
                p = jax.tree_util.tree_map(torch.from_numpy, p)
                trainers.append(TTrainer(p, "sgd", spec, kvstore=kv))

        def conv(g):
            return jax.tree_util.tree_map(
                jnp.asarray if pkg == "jax" else torch.from_numpy, g)

        for k in range(steps):
            if store == "dist_async":
                for i, tr in enumerate(trainers):
                    tr.step(conv(_trainer_grads(k, i)), batch_size=4)
            else:
                _parallel([lambda i=i, tr=tr: tr.step(
                    conv(_trainer_grads(k, i)), batch_size=4)
                    for i, tr in enumerate(trainers)])
        return [np.asarray(ravel_pytree(jax.tree_util.tree_map(
            np.asarray, tr.params))[0]) for tr in trainers]
    finally:
        for c in ctrls:
            c.close()
        sched.close()


def test_trainer_two_workers_dist_async_matches_the_jax_trainer():
    ref = _trainers("jax", "dist_async")
    got = _trainers("port", "dist_async")
    # the last pusher holds the final master; w0 the one before it
    for a, b in zip(got, ref):
        assert a.tobytes() == b.tobytes()
    with pytest.raises(RuntimeError, match="scheduler"):
        TTrainer(jax.tree_util.tree_map(torch.from_numpy,
                                        _trainer_params()),
                 "sgd", kvstore="dist_async").save_states("x")


def test_trainer_two_workers_tpu_sync_matches_the_jax_trainer(monkeypatch):
    ref = _trainers("jax", "tpu_sync")
    got = {o: _trainers("port", "tpu_sync", overlap=o,
                        monkeypatch=monkeypatch) for o in ("1", "0")}
    for o, ws in got.items():
        assert ws[0].tobytes() == ws[1].tobytes(), o
        np.testing.assert_allclose(ws[0], ref[0], rtol=1e-6, atol=1e-6)
    assert got["1"][0].tobytes() == got["0"][0].tobytes()


def test_dist_async_halt_withholds_the_push(monkeypatch):
    """A NaN batch under ``DT_HEALTH_HALT=1`` over ``dist_async``: the
    worker stops after its clean step and the non-finite gradient never
    reaches the server, whose master stays the one the clean push made
    (finite, and the worker's params); the two packages agree."""
    from dt_tpu_torch.obs import metrics as tobs
    monkeypatch.setenv("DT_HEALTH_HALT", "1")
    rng = np.random.RandomState(0)
    x = rng.normal(size=(32, 4, 4, 1)).astype(np.float32)
    x[16:] = np.nan
    y = np.random.RandomState(1).randint(0, 2, 32).astype(np.int32)
    masters = {}
    try:
        for p in ("jax", "port"):
            import dt_tpu.models as jmodels
            jmodel = jmodels.create("mlp", num_classes=2, hidden=())
            sched = (JScheduler if p == "jax" else TScheduler)(
                initial_workers=["w0"])
            ctrl = (JClient if p == "jax" else TClient)(
                "127.0.0.1", sched.port, host="w0", heartbeat_interval_s=0.5)
            try:
                kv = (jkv if p == "jax" else tkv).create("dist_async")
                kv.set_controller(ctrl)
                jmod = JModule(jmodel, optimizer="sgd",
                               optimizer_params={"learning_rate": 0.1},
                               kvstore=kv if p == "jax" else "local", seed=0)
                jmod.init_params(x[:16])
                mod, io = jmod, jio
                if p == "port":
                    mod = TModule(tmodels.create(
                        "mlp", device="cpu", in_shape=(4, 4, 1),
                        num_classes=2, hidden=()), optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1}, kvstore=kv,
                        device="cpu")
                    mod.init_params()
                    load_jax_variables(mod.model, {
                        "params": jax.device_get(jmod.state.params),
                        "batch_stats": {}})
                    io = tio
                mod.fit(io.NDArrayIter(x, y, batch_size=16), num_epoch=3)
                assert mod.health_halted is True
                assert int(mod.state.step) == 1
                masters[p] = np.array(sched._async_store["params"])
            finally:
                ctrl.close()
                sched.close()
    finally:
        tobs.set_enabled(None)
    assert np.isfinite(masters["port"]).all()
    np.testing.assert_allclose(masters["port"], masters["jax"], rtol=1e-6,
                               atol=1e-7)
