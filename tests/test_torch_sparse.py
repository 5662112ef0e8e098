"""The port's row-sparse ops and lazy optimizers against the JAX package's
(``dt_tpu/ops/sparse.py``, ``dt_tpu/optim/sparse.py``) on the CPU: the same
seeded numpy inputs through both, slot for slot, values within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu.ops import sparse as jsp
from dt_tpu.optim import sparse as josp
from dt_tpu_torch.ops import sparse as tsp
from dt_tpu_torch.optim import sparse as tosp
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

TOL = 1e-6


def _pair(ids, vals, n):
    return (jsp.RowSparse(jnp.asarray(ids, jnp.int32), jnp.asarray(vals), n),
            tsp.RowSparse(torch.from_numpy(np.asarray(ids, np.int32)),
                          torch.from_numpy(vals), n))


def _same_rs(j, t):
    assert t.num_rows == j.num_rows and t.nnz == j.nnz
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_allclose(t.values.numpy(), np.asarray(j.values),
                               rtol=TOL, atol=TOL)


def _rs_inputs(seed=0, nnz=11, n=9, dim=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, n + 1, size=nnz)  # n: a sentinel slot
    vals = rng.normal(size=(nnz, dim)).astype(np.float32)
    return ids, vals, n


@pytest.mark.parametrize("op", ["to_dense", "aggregate_duplicates",
                                "sparse_retain", "row_sparse_from_dense"])
def test_row_sparse_ops_match(op):
    ids, vals, n = _rs_inputs()
    j, t = _pair(ids, vals, n)
    if op == "to_dense":
        np.testing.assert_allclose(t.to_dense().numpy(),
                                   np.asarray(j.to_dense()), rtol=TOL,
                                   atol=TOL)
    elif op == "aggregate_duplicates":
        _same_rs(jsp.aggregate_duplicates(j), tsp.aggregate_duplicates(t))
    elif op == "sparse_retain":
        keep = np.array([0, 3, 4, 8])
        _same_rs(jsp.sparse_retain(j, jnp.asarray(keep)),
                 tsp.sparse_retain(t, torch.from_numpy(keep)))
    else:
        dense = np.array(j.to_dense())
        for nnz in (None, 3):
            _same_rs(jsp.row_sparse_from_dense(jnp.asarray(dense), nnz),
                     tsp.row_sparse_from_dense(torch.from_numpy(dense), nnz))


def test_embedding_lookup_and_sparse_grad_match():
    """The sparse-grad embedding: loss, the RowSparse table gradient (one
    slot per id, duplicates unsummed) and the gradient of a dense
    argument."""
    rng = np.random.RandomState(2)
    table = rng.normal(size=(20, 4)).astype(np.float32)
    proj = rng.normal(size=(4, 3)).astype(np.float32)
    ids = rng.randint(0, 20, size=(5, 3))
    tgt = rng.randint(0, 3, size=5)

    def jloss(rows, p, y):
        logits = rows.mean(axis=1) @ p
        z = logits - logits.max(axis=1, keepdims=True)
        logp = z - jnp.log(jnp.exp(z).sum(axis=1, keepdims=True))
        return -jnp.mean(logp[jnp.arange(5), y])

    def tloss(rows, p, y):
        logits = rows.mean(dim=1) @ p
        return -torch.log_softmax(logits, dim=1)[torch.arange(5), y].mean()

    np.testing.assert_array_equal(
        tsp.embedding_lookup(torch.from_numpy(table),
                             torch.from_numpy(ids)).numpy(),
        np.asarray(jsp.embedding_lookup(jnp.asarray(table),
                                        jnp.asarray(ids))))
    jl, (jrs, jg) = jsp.embedding_value_and_grad(jloss, argnums=(0,))(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(proj),
        jnp.asarray(tgt))
    tl, (trs, tg) = tsp.embedding_value_and_grad(tloss, argnums=(0,))(
        torch.from_numpy(table), torch.from_numpy(ids),
        torch.from_numpy(proj), torch.from_numpy(tgt))
    assert abs(float(tl) - float(jl)) <= TOL
    _same_rs(jrs, trs)
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg[0]), rtol=TOL,
                               atol=TOL)


OPTS = {
    "sgd": dict(cls="sparse_sgd", kw=dict(learning_rate=0.1)),
    "sgd_momentum_wd_clip": dict(cls="sparse_sgd", kw=dict(
        learning_rate=0.1, momentum=0.9, weight_decay=1e-2,
        rescale_grad=0.5, clip_gradient=0.4)),
    "sgd_std_update": dict(cls="sparse_sgd", kw=dict(
        learning_rate=0.1, momentum=0.9, weight_decay=1e-2,
        lazy_update=False)),
    "sgd_std_update_plain": dict(cls="sparse_sgd", kw=dict(
        learning_rate=0.1, weight_decay=1e-2, lazy_update=False)),
    "adagrad": dict(cls="sparse_adagrad", kw=dict(
        learning_rate=0.1, weight_decay=1e-3)),
}


@pytest.mark.parametrize("tag", sorted(OPTS))
def test_lazy_optimizers_match(tag):
    """Four updates with duplicate ids and sentinels: table and state
    within 1e-6 each step; lazy paths leave untouched rows (and their
    momentum or history) as they were."""
    spec = OPTS[tag]
    jo = getattr(josp, spec["cls"])(**spec["kw"])
    to = getattr(tosp, spec["cls"])(**spec["kw"])
    rng = np.random.RandomState(3)
    table = rng.normal(size=(9, 3)).astype(np.float32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table.copy())
    js, ts = jo.init(jt), to.init(tt)
    for step in range(4):
        ids, vals, n = _rs_inputs(seed=10 + step)
        jg, tg = _pair(ids, vals, n)
        before = tt.clone()
        jt, js = jo.update(jg, js, jt)
        tt, ts = to.update(tg, ts, tt)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=TOL,
                                   atol=TOL)
        assert ts.count == int(js.count)
        for jx, tx in zip(js[1:], ts[1:]):
            if jx is None:
                assert tx is None
            else:
                np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                                           rtol=TOL, atol=TOL)
        if spec["kw"].get("lazy_update", True):
            untouched = np.setdiff1d(np.arange(n), ids)
            assert torch.equal(tt[untouched], before[untouched])


def test_csr_and_cast_storage_name_their_item():
    for fn in (lambda: tsp.CSR(None, None, None, (2, 2)),
               lambda: tsp.csr_dot_dense(None, None),
               lambda: tsp.cast_storage(torch.zeros(2, 2), "csr")):
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            fn()
