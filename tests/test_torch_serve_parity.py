"""The port's serving plane against the JAX package's (``dt_tpu.serve``) on
the CPU.

- The ``DT_SERVE_*`` rows of the port's environment table are the JAX
  package's, name, default and help.
- ``DynamicBatcher`` and ``ServePolicy.decide`` give the JAX package's
  numbers on one seeded sequence (exactly: both are pure arithmetic).
- One scripted heartbeat load into each package's scheduler with
  ``DT_SERVE_POLICY=1``: the ``serve_endpoints`` replies are equal and the
  decision logs byte-equal.
- Mixed fleets: a JAX toy replica and a port one behind either package's
  scheduler, each package's ``InferClient`` answered by either gateway,
  each package's ``RollingRefresher`` rolling both (float32, rtol 1e-5
  against the numpy oracle, 1e-6 between the packages).
- A small ResNet (``resnet20`` at 8x8, the weights moved by
  ``interchange.load_jax_variables``) behind a JAX gateway and a port
  gateway, and both refreshed from one fleet-checkpoint blob that the JAX
  package wrote: the answers agree within 1e-4 (float32; CPU convolutions
  sum in another order).
- The ``predict.*`` counters and the ``predict.ms`` histogram of both
  predictors over one request sequence.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dt_tpu import config as jconfig
from dt_tpu import models as jmodels
from dt_tpu import optim as joptim
from dt_tpu.elastic import protocol as jproto
from dt_tpu.elastic.scheduler import Scheduler as JScheduler
from dt_tpu.obs import metrics as jmetrics
from dt_tpu.obs import trace as jtrace
from dt_tpu.policy.engine import ServePolicy as JServePolicy
from dt_tpu.predictor import Predictor as JPredictor
from dt_tpu.serve import refresh as jrefresh
from dt_tpu.serve import replica as jreplica
from dt_tpu.serve.client import InferClient as JInferClient
from dt_tpu.serve.gateway import DynamicBatcher as JBatcher
from dt_tpu.serve.gateway import Gateway as JGateway
from dt_tpu.serve.refresh import RollingRefresher as JRefresher
from dt_tpu.training import checkpoint as jckpt
from dt_tpu.training.train_state import TrainState as JTrainState
from dt_tpu_torch import config as tconfig
from dt_tpu_torch import models as tmodels
from dt_tpu_torch import optim as toptim
from dt_tpu_torch.elastic import protocol as tproto
from dt_tpu_torch.elastic.scheduler import Scheduler as TScheduler
from dt_tpu_torch.obs import metrics as tmetrics
from dt_tpu_torch.obs import trace as ttrace
from dt_tpu_torch.policy import ServePolicy as TServePolicy
from dt_tpu_torch.predictor import Predictor as TPredictor
from dt_tpu_torch.serve import refresh as trefresh
from dt_tpu_torch.serve import replica as treplica
from dt_tpu_torch.serve.client import InferClient as TInferClient
from dt_tpu_torch.serve.gateway import DynamicBatcher as TBatcher
from dt_tpu_torch.serve.gateway import Gateway as TGateway
from dt_tpu_torch.serve.refresh import RollingRefresher as TRefresher
from dt_tpu_torch.training.train_state import TrainState as TTrainState
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

F, C = 4, 3  # the toy linear model
TOL_TOY = 1e-6  # f32 x @ w, XLA against torch on the CPU
ROW = (8, 8, 3)  # resnet20's request rows
BUCKETS = (1, 2, 4, 8)
TOL_RESNET = 1e-4  # f32 logits; CPU convolutions sum in another order


def test_serve_env_rows_are_the_jax_packages():
    serve = sorted(k for k in jconfig.ENV_REGISTRY
                   if k.startswith("DT_SERVE_"))
    assert len(serve) == 10
    for k in serve:
        assert tconfig.ENV_REGISTRY[k] == jconfig.ENV_REGISTRY[k], k
    # every row the two tables share has the JAX package's default
    for k in set(tconfig.ENV_REGISTRY) & set(jconfig.ENV_REGISTRY):
        assert tconfig.ENV_REGISTRY[k][0] == jconfig.ENV_REGISTRY[k][0], k


def test_port_wire_sets_are_the_registry_views():
    """The port's token-exempt and passive sets are the views
    ``dt_tpu/elastic/commands.py`` derives, for the scheduler, the range
    server and the replica's gateway, and the port's scheduler has an arm
    for every scheduler command of the registry (none is left unported)."""
    import inspect

    from dt_tpu.elastic import commands
    from dt_tpu_torch.elastic import range_server, scheduler
    from dt_tpu_torch.elastic.dataplane import DataPlane
    from dt_tpu_torch.serve import gateway
    assert scheduler._TOKEN_EXEMPT == commands.token_exempt("scheduler")
    assert scheduler._PASSIVE_CMDS == commands.passive_cmds()
    assert range_server._TOKEN_EXEMPT == \
        commands.token_exempt("range_server")
    assert gateway._TOKEN_EXEMPT == commands.token_exempt("replica")
    assert scheduler.UNPORTED == {}
    src = inspect.getsource(scheduler.Scheduler)
    for cmd, (roles, *_rest) in commands.PROTOCOL_REGISTRY.items():
        if "scheduler" in roles.split("|"):
            assert f'cmd == "{cmd}"' in src or cmd in DataPlane.CMDS, cmd
    gsrc = inspect.getsource(gateway.Gateway)
    for cmd, (roles, *_rest) in commands.PROTOCOL_REGISTRY.items():
        if "replica" in roles.split("|"):
            assert f'cmd == "{cmd}"' in gsrc, cmd


# ---------------------------------------------------------------------------
# the pure arithmetic, on one seeded sequence
# ---------------------------------------------------------------------------


def test_batcher_plan_admit_wakeup_equal_on_a_seeded_sequence():
    rng = np.random.RandomState(0)
    for buckets, deadline, cap in (([1, 2, 4, 8], 50.0, 64),
                                   ([1, 2, 4, 8, 16, 32, 64], 50.0, 256),
                                   ([3, 5], 7.5, 9)):
        jb, tb = JBatcher(buckets, deadline, cap), \
            TBatcher(buckets, deadline, cap)
        assert (tb.buckets, tb.max_batch) == (jb.buckets, jb.max_batch)
        for _ in range(300):
            k = rng.randint(0, 12)
            t0 = float(rng.uniform(0, 1e4))
            pending = [(int(rng.randint(1, jb.max_batch + 1)),
                        t0 + float(rng.uniform(0, deadline)))
                       for _ in range(k)]
            pending.sort(key=lambda p: p[1])
            now = t0 + float(rng.uniform(0, 2 * deadline))
            assert tb.plan(pending, now) == jb.plan(pending, now)
            q, n = int(rng.randint(0, cap + 4)), int(rng.randint(-1, 70))
            assert tb.admit(q, n) == jb.admit(q, n)
            assert tb.bucket_of(n) == jb.bucket_of(n)
            assert tb.next_wakeup_ms(t0) == jb.next_wakeup_ms(t0)


def test_serve_policy_decide_equal_on_seeded_sequences():
    rng = np.random.RandomState(1)
    for _ in range(20):
        kw = dict(q_hi=float(rng.uniform(1, 10)),
                  q_lo=float(rng.uniform(0, 1)),
                  up_after=int(rng.randint(0, 4)),
                  down_after=int(rng.randint(0, 6)),
                  min_replicas=int(rng.randint(0, 3)),
                  max_replicas=int(rng.randint(0, 6)))
        jp, tp = JServePolicy(**kw), TServePolicy(**kw)
        assert vars(tp) == vars(jp)
        hosts = [f"s{i}" for i in range(6)]
        jh = jl = th = tl = 0
        for _ in range(60):
            live = sorted(rng.choice(hosts, rng.randint(1, 6),
                                     replace=False).tolist())
            base = set(live[:kw["min_replicas"]])
            depths = {h: float(rng.choice([0.0, 0.3, 2.0, 9.0, 20.0]))
                      for h in live if rng.rand() < 0.9}
            jd = jp.decide(live, base, depths, jh, jl)
            td = tp.decide(live, base, depths, th, tl)
            assert vars(td) == vars(jd)
            jh, jl, th, tl = jd.hi_streak, jd.lo_streak, td.hi_streak, \
                td.lo_streak


def test_scripted_heartbeats_give_equal_views_and_logs(tmp_path,
                                                        monkeypatch):
    for k, v in (("DT_SERVE_POLICY", "1"), ("DT_SERVE_QHI", "4"),
                 ("DT_SERVE_QLO", "0.5"), ("DT_SERVE_UP_AFTER", "2"),
                 ("DT_SERVE_DOWN_AFTER", "2"),
                 ("DT_SERVE_MIN_REPLICAS", "1"),
                 ("DT_SERVE_MAX_REPLICAS", "2")):
        monkeypatch.setenv(k, v)
    scheds = (JScheduler(initial_workers=[],
                         host_worker_file=str(tmp_path / "jh")),
              TScheduler(initial_workers=[],
                         host_worker_file=str(tmp_path / "th")))
    try:
        def both(msg):
            return [jproto.request("127.0.0.1", s.port, dict(msg))
                    for s in scheds]

        def beat(host, depth, step=0):
            return both({"cmd": "serve_heartbeat", "host": host,
                         "gauges": {"serve.queue_depth": depth,
                                    "serve.qps": 2.5},
                         "weights_step": step, "refreshes": step})

        replies = [both({"cmd": "serve_register", "host": "s0",
                         "addr": ["127.0.0.1", 1], "weights_step": 0})]
        # an unknown host is told to register
        replies.append(beat("ghost", 0.0))
        # evaluations are throttled to one each 0.25 s: rounds 0.3 s apart
        for _ in range(5):
            replies.append(beat("s0", 9.0))
            time.sleep(0.3)
        replies.append(both({"cmd": "serve_register", "host": "s1",
                             "addr": ["127.0.0.1", 2],
                             "weights_step": 0}))
        for _ in range(6):
            replies.append(beat("s0", 0.0, 3))
            replies.append(beat("s1", 0.0, 3))
            time.sleep(0.3)
        replies.append(both({"cmd": "serve_endpoints"}))
        for j, t in replies:
            assert t == j
        view = replies[-1][0]
        assert view["want"] == 1 and view["replicas"]["s1"]["draining"]
        logs = [json.dumps(r["decisions"], sort_keys=True).encode()
                for r in replies[-1]]
        assert logs[0] == logs[1]
        assert json.loads(logs[0]) == [
            {"seq": 0, "kind": "scale_up", "n_before": 1, "n_after": 2},
            {"seq": 1, "kind": "scale_down", "n_before": 2, "n_after": 1,
             "host": "s1"}]
        st = both({"cmd": "status"})
        assert st[1]["serving"] == st[0]["serving"] == {
            "replicas": ["s0", "s1"], "want": 1, "decisions": 2}
        dumps = [s.obs_dump()["serving"] for s in scheds]
        assert dumps[1] == dumps[0]
    finally:
        for s in scheds:
            s.close()


# ---------------------------------------------------------------------------
# mixed fleets
# ---------------------------------------------------------------------------


def _jax_replica(host, eps):
    pred = jreplica.toy_predictor(F, C, max_batch=8)
    pred.warmup(feature_shape=(F,))
    return jreplica.Replica(
        pred, host, eps, heartbeat_s=0.1,
        refresh_loader=lambda s, _m: jreplica.params_for_step(F, C, s),
        advertise_host="127.0.0.1")


def _port_replica(host, eps):
    pred = treplica.toy_predictor(F, C, max_batch=8, device="cpu")
    pred.warmup(feature_shape=(F,))
    return treplica.Replica(
        pred, host, eps, heartbeat_s=0.1,
        refresh_loader=lambda s, _m: treplica.params_for_step(F, C, s),
        advertise_host="127.0.0.1")


@pytest.mark.parametrize("sched_pkg", ["jax", "port"])
def test_mixed_fleet_registers_serves_and_refreshes(tmp_path, sched_pkg):
    sched = (JScheduler if sched_pkg == "jax" else TScheduler)(
        initial_workers=[], host_worker_file=str(tmp_path / "hosts"))
    eps = f"127.0.0.1:{sched.port}"
    reps = []
    try:
        reps = [_jax_replica("j0", eps), _port_replica("t0", eps)]
        # both registered and heartbeating (their gauges arrived)
        deadline = time.time() + 20
        while True:
            v = jproto.request("127.0.0.1", sched.port,
                               {"cmd": "serve_endpoints"})
            if sorted(v["replicas"]) == ["j0", "t0"] and \
                    all(e["gauges"] for e in v["replicas"].values()):
                break
            assert time.time() < deadline
            time.sleep(0.05)
        addrs = {h: tuple(e["addr"]) for h, e in v["replicas"].items()}
        assert addrs == {"j0": ("127.0.0.1", reps[0].gateway.port),
                         "t0": ("127.0.0.1", reps[1].gateway.port)}
        rng = np.random.RandomState(5)

        def ask_all(step):
            w = treplica.params_for_step(F, C, step)["w"]
            for n in (1, 3, 8):
                x = rng.randn(n, F).astype(np.float32)
                outs = []
                for client in (JInferClient, TInferClient):
                    for addr in addrs.values():
                        out = client(replicas=[addr]).infer(x)
                        assert out["weights_step"] == step
                        outs.append(out["y"])
                    # discovery through the scheduler: every replica
                    c = client(scheduler=eps)
                    outs += [c.infer(x)["y"] for _ in range(2)]
                for y in outs:
                    np.testing.assert_allclose(y, x @ w, rtol=1e-5)
                    np.testing.assert_allclose(y, outs[0], rtol=TOL_TOY,
                                               atol=TOL_TOY)

        ask_all(0)
        # the other package's refresher rolls both replicas
        refresher = (TRefresher if sched_pkg == "jax" else JRefresher)(eps)
        out = refresher.poll_once(step=3, manifest=None)
        assert sorted(out["applied"]) == ["j0", "t0"], out
        ask_all(3)
        deadline = time.time() + 10
        while True:
            v = jproto.request("127.0.0.1", sched.port,
                               {"cmd": "serve_endpoints"})
            if all(e["weights_step"] == 3 and e["refreshes"] == 1
                   for e in v["replicas"].values()):
                break
            assert time.time() < deadline
            time.sleep(0.05)
    finally:
        for r in reps:
            r.close()
        sched.close()


# ---------------------------------------------------------------------------
# a small ResNet behind both gateways, refreshed from a JAX-written blob
# ---------------------------------------------------------------------------


def _jax_state(seed):
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

    v = jax.tree_util.tree_map_with_path(one, shapes)
    return JTrainState.create(model.apply, v["params"], joptim.create("sgd"),
                              v["batch_stats"])


@pytest.fixture(scope="module")
def resnet_fleet(tmp_path_factory):
    """A resnet20 checkpoint (seed 1) behind a JAX gateway and a port one,
    and a JAX-written fleet-checkpoint blob of another state (seed 2,
    step 9) with its manifest."""
    tmp = tmp_path_factory.mktemp("serve_resnet")
    prefix = str(tmp / "r20")
    jckpt.save_checkpoint(prefix, 1,
                          _jax_state(1).replace(step=jnp.int32(1)))
    sample = np.zeros((1,) + ROW, np.float32)
    jp = JPredictor("resnet20", prefix, 1, sample, batch_buckets=BUCKETS,
                    num_classes=10)
    tp = TPredictor("resnet20", prefix, 1, sample, batch_buckets=BUCKETS,
                    device="cpu", num_classes=10)
    fleet = str(tmp / "fleet" / "w0" / "fleet")
    path = jckpt.save_checkpoint(fleet, 9,
                                 _jax_state(2).replace(step=jnp.int32(9)))
    manifest = {"step": 9, "epoch": 1, "seq": 1, "workers": ["w0"],
                "files": {"w0": {"path": path, "sha256": jckpt.
                                 checkpoint_info(fleet, 9)["sha256"],
                                 "cursor": {}}}}
    template = _jax_state(0)
    port_template = TTrainState.create(
        tmodels.create("resnet20", device="cpu", num_classes=10),
        toptim.create("sgd"))
    jgw = JGateway(jp, name="parity-jax",
                   refresh_loader=jrefresh.manifest_loader(template))
    tgw = TGateway(tp, name="parity-port",
                   refresh_loader=trefresh.manifest_loader(port_template))
    yield {"jax": ("127.0.0.1", jgw.port), "port": ("127.0.0.1", tgw.port),
           "manifest": manifest, "jp": jp, "tp": tp}
    jgw.close()
    tgw.close()


def _answers(addrs, step, seed):
    """The same seeded rows through each package's client to each gateway;
    returns the port gateway's answers after holding every answer to the
    JAX gateway's."""
    rng = np.random.RandomState(seed)
    got = []
    for n in (1, 3, 6, 8):
        x = rng.uniform(-1, 1, (n,) + ROW).astype(np.float32)
        want = JInferClient(replicas=[addrs["jax"]]).infer(x)
        assert want["weights_step"] == step
        for client in (JInferClient, TInferClient):
            for where in ("jax", "port"):
                out = client(replicas=[addrs[where]]).infer(x)
                assert out["weights_step"] == step
                np.testing.assert_allclose(out["y"], want["y"],
                                           rtol=TOL_RESNET, atol=TOL_RESNET)
        got.append(TInferClient(replicas=[addrs["port"]]).infer(x)["y"])
    return got


def test_resnet_gateways_answer_alike_and_refresh_from_a_jax_blob(
        resnet_fleet):
    before = _answers(resnet_fleet, 0, seed=3)
    manifest = resnet_fleet["manifest"]
    for where, proto in (("jax", tproto), ("port", jproto)):
        host, port = resnet_fleet[where]
        r = proto.request(host, port, {"cmd": "weight_refresh", "step": 9,
                                       "manifest": manifest})
        assert r == {"weights_step": 9, "applied": True}, (where, r)
        # keyed by step: a second refresh of it is a no-op
        r = proto.request(host, port, {"cmd": "weight_refresh", "step": 9,
                                       "manifest": manifest})
        assert r == {"weights_step": 9, "applied": False}, (where, r)
    after = _answers(resnet_fleet, 9, seed=3)
    for b, a in zip(before, after):
        assert np.abs(a - b).max() > 1e-2  # the new weights are served


def test_predict_counters_match_the_jax_predictor(resnet_fleet):
    jp, tp = resnet_fleet["jp"], resnet_fleet["tp"]
    for m in (jmetrics, tmetrics):
        m.set_enabled(True)
    try:
        def counts(tr, reg):
            hist = {h[0]: h[2]["count"] for h in reg.hists_export()}
            return {**{k: tr.get_counter(f"predict.{k}")
                       for k in ("requests", "rows", "compiles")},
                    "ms": hist.get("predict.ms", 0)}

        jb = counts(jtrace.tracer(), jmetrics.registry())
        tb = counts(ttrace.tracer(), tmetrics.registry())
        js, ts = dict(jp.stats), dict(tp.stats)
        rng = np.random.RandomState(7)
        # every bucket warmed at ROW, one bucket at a new row shape: the
        # other buckets of the new shape count a compile in both
        for p in (tp, jp):
            p.warmup(feature_shape=ROW)
            p.warmup(feature_shape=(16, 16, 3), buckets=[2])
        for n, row in ((2, (16, 16, 3)), (3, (16, 16, 3)), (1, ROW),
                       (0, ROW), (19, ROW), (3, (16, 16, 3))):
            x = rng.uniform(-1, 1, (n,) + row).astype(np.float32)
            np.testing.assert_allclose(tp.predict(x),
                                       np.asarray(jp.predict(x)),
                                       rtol=TOL_RESNET, atol=TOL_RESNET)
        ja = counts(jtrace.tracer(), jmetrics.registry())
        ta = counts(ttrace.tracer(), tmetrics.registry())
        delta = {k: ta[k] - tb[k] for k in ta}
        assert delta == {k: ja[k] - jb[k] for k in ja}
        assert delta == {"requests": 6, "rows": 28, "compiles": 1, "ms": 6}
        for k in ("requests", "rows", "compiles"):
            assert tp.stats[k] - ts[k] == jp.stats[k] - js[k] == delta[k]
    finally:
        for m in (jmetrics, tmetrics):
            m.set_enabled(None)
