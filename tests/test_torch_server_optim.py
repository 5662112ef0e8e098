"""The port's server-side ``dist_async`` optimizers against the JAX
package's (``dt_tpu/elastic/server_optim.py``), bit for bit: a mixed fleet
shares one master, so both must move it identically.  Seeded push
sequences (numpy) go through both ``NpUpdater``s: sgd (plain, momentum,
weight decay), adagrad and adam dense, and sgd and adagrad lazy-sparse
with duplicate and out-of-table ids; adam's sparse update and unknown
names are refused the same way."""

import numpy as np
import pytest

from dt_tpu.elastic import server_optim as jopt
from dt_tpu_torch.elastic import server_optim as topt
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

SPECS = {
    "sgd": {"name": "sgd", "learning_rate": 0.05},
    "sgd_momentum_wd": {"name": "sgd", "learning_rate": 0.05,
                        "momentum": 0.9, "weight_decay": 1e-3},
    "adagrad": {"name": "adagrad", "learning_rate": 0.1,
                "weight_decay": 1e-4, "epsilon": 1e-7},
    "adam": {"name": "adam", "learning_rate": 0.01, "beta1": 0.8,
             "beta2": 0.99, "weight_decay": 1e-4},
}


def _updaters(spec):
    return jopt.create(**dict(spec)), topt.create(**dict(spec))


@pytest.mark.parametrize("tag", sorted(SPECS))
def test_dense_push_sequence_is_bit_identical(tag):
    """Six pushes on two keys, interleaved: every returned master and the
    slots bit for bit."""
    ju, tu = _updaters(SPECS[tag])
    rng = np.random.RandomState(0)
    stored = {k: (rng.normal(size=(5, 7)).astype(np.float32),) * 2
              for k in ("a", "b")}
    for i in range(6):
        key = "ab"[i % 2]
        g = rng.normal(size=(5, 7)).astype(np.float32)
        jw = ju(key, g, stored[key][0])
        tw = tu(key, g, stored[key][1])
        assert jw.dtype == tw.dtype == np.float32
        assert jw.tobytes() == tw.tobytes(), (tag, i)
        stored[key] = (jw, tw)
    for key in ("a", "b"):
        js, ts = ju._slots[key], tu._slots[key]
        assert js.keys() == ts.keys()
        for name in js:
            assert np.asarray(js[name]).tobytes() == \
                np.asarray(ts[name]).tobytes(), (tag, key, name)
    assert ju.spec_input == tu.spec_input == topt.spec_identity(SPECS[tag])


@pytest.mark.parametrize("tag", ["sgd", "sgd_momentum_wd", "adagrad"])
def test_lazy_sparse_push_sequence_is_bit_identical(tag):
    """Sparse pushes with duplicates and ids outside the table: the same
    rows move by the same bits, untouched rows (and their momentum) stay,
    and ``stored`` is never written."""
    ju, tu = _updaters(SPECS[tag])
    rng = np.random.RandomState(1)
    w0 = rng.normal(size=(12, 4)).astype(np.float32)
    jw, tw = w0.copy(), w0.copy()
    for i in range(5):
        ids = rng.randint(-1, 14, size=9)  # -1 and 12, 13: dropped
        vals = rng.normal(size=(9, 4)).astype(np.float32)
        before = tw.copy()
        jn = ju.sparse("emb", ids, vals, jw)
        tn = tu.sparse("emb", ids, vals, tw)
        assert jn.tobytes() == tn.tobytes(), (tag, i)
        assert tw.tobytes() == before.tobytes()  # not written in place
        live = np.unique(ids[(ids >= 0) & (ids < 12)])
        untouched = np.setdiff1d(np.arange(12), live)
        assert tn[untouched].tobytes() == tw[untouched].tobytes()
        jw, tw = jn, tn
    for name in ju._slots["emb"]:
        assert ju._slots["emb"][name].tobytes() == \
            tu._slots["emb"][name].tobytes()


def test_refusals_match():
    ju, tu = _updaters(SPECS["adam"])
    w = np.zeros((3, 2), np.float32)
    msgs = []
    for u in (ju, tu):
        with pytest.raises(ValueError, match="adam") as e:
            u.sparse("k", np.array([0]), np.ones((1, 2), np.float32), w)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    for mod in (jopt, topt):
        with pytest.raises(ValueError, match="unsupported"):
            mod.create("ftrl", learning_rate=0.1)
    # a worker-side knob in the spec is kept in the identity, not passed on
    spec = {"name": "sgd", "learning_rate": 0.1, "lr_scheduler": "x"}
    assert topt.create(**spec).spec_input == jopt.create(**spec).spec_input
