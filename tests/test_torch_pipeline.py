"""The port's GPipe pipeline against ``dt_tpu``'s, on the CPU.

A 4-process gloo world (``tests/torch_parallel_worker.py``, case ``pipe``)
against JAX on this process's 8-device CPU mesh:

- ``pipeline_apply`` on the JAX tests' ``tanh(h w + b)`` stages over a
  4-rank ``pipe`` axis, 6 microbatches (``tests/test_pipeline.py``): the
  output within 1e-5 of JAX's and of ``sequential_apply``, every rank's
  slice of the stacked params' gradient of ``sum(out^2)`` within 1e-4 of
  ``jax.grad``'s slice (the other slices zero);
- the ``PipelinedTransformerLM`` (2 stages, 4 microbatches) over a data 2 x
  pipe 2 mesh (each stage rank holds its stage only): each data rank's
  logits within 2e-4 of the JAX model's on the same rows
  (``tests/test_pipeline_transformer.py:44``'s tolerance), and after 2 sgd
  steps of ``Module.fit`` (``:94-103``'s dp x pp step) the outer params and
  each rank's stage within 1e-4 relative of the JAX ``Module``'s on the
  same 2 x 2 mesh;
- in one process: the sequential path equals the JAX model, ``remat_stages``
  changes no gradient bit, ``create("transformer_lm_pipelined")`` builds
  it, and the JAX errors' texts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu import data as jdata
from dt_tpu import models as jmodels
from dt_tpu.parallel import mesh as jmesh
from dt_tpu.parallel.pipeline import pipeline_apply as jpipeline
from dt_tpu.parallel.pipeline import sequential_apply as jsequential
from dt_tpu.training.module import Module as JModule
from dt_tpu_torch import models as tmodels
from dt_tpu_torch.interchange import export_jax_variables, load_jax_variables
from dt_tpu_torch.parallel import mesh as tmesh
from dt_tpu_torch.parallel.pipeline import pipeline_apply, sequential_apply
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)
from torch_parallel_worker import SGD, flat, lm_loss, run_world

V, D, L, H, S = 64, 32, 4, 4, 16  # the JAX test's vocab, dim, layers, ...
LM = dict(vocab_size=V, embed_dim=D, num_layers=L, num_heads=H, max_len=S,
          num_stages=2, num_micro=4)
BATCH, STEPS = 8, 2


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _toy(stages=4, micro=6, mb=2, d=8, seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.normal(0, 0.5, (stages, d, d)).astype(np.float32),
            "b": rng.normal(0, 0.1, (stages, d)).astype(np.float32),
            "x_toy": rng.normal(0, 1, (micro, mb, d)).astype(np.float32)}


def _jstage(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def _tstage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _jax_lm_loss(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1))


@pytest.fixture(scope="module")
def pipe_case(tmp_path_factory):
    toy = _toy()
    params = {"w": jnp.asarray(toy["w"]), "b": jnp.asarray(toy["b"])}
    mesh4 = jmesh.make_mesh(data=4, model=1, axis_names=("pipe", "model"),
                            devices=jax.devices()[:4])

    def loss(p):
        out = jpipeline(_jstage, p, jnp.asarray(toy["x_toy"]), mesh4,
                        axis_name="pipe")
        return jnp.sum(out ** 2), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    ref = {"toy/out": out, "toy/dw": g["w"], "toy/db": g["b"],
           "toy/seq": jsequential(_jstage, params,
                                  jnp.asarray(toy["x_toy"]))}
    # the LM: logits of the JAX model, then its Module over data x pipe
    mesh = jmesh.make_mesh(data=2, model=2, axis_names=("data", "pipe"),
                           devices=jax.devices()[:4])
    model = jmodels.PipelinedTransformerLM(mesh=mesh, batch_axis="data",
                                           **LM)
    rng = np.random.RandomState(3)
    x = rng.randint(0, V, (BATCH * STEPS, S)).astype(np.int32)
    y = np.roll(x, -1, axis=1).astype(np.int32)
    mod = JModule(model, loss_fn=_jax_lm_loss, optimizer="sgd",
                  optimizer_params=SGD, mesh=mesh, seed=5)
    mod.init_params(x[:BATCH])
    init = jax.device_get(mod.state.params)
    ref["logits"] = model.apply({"params": init}, jnp.asarray(x[:BATCH]))
    mod.fit(jdata.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1)
    ref.update(flat(jax.device_get(mod.state.params), "params"))
    inputs = dict(toy, toks=x[:BATCH], x=x, y=y, batch=np.int64(BATCH),
                  **flat(init, "init"),
                  **{f"cfg/{k}": np.int64(v) for k, v in LM.items()})
    ranks = run_world(str(tmp_path_factory.mktemp("pipe")), "pipe", inputs)
    return ranks, {k: np.asarray(v) for k, v in ref.items()}


def test_pipeline_apply_matches_jax(pipe_case):
    ranks, ref = pipe_case
    for r in ranks:
        np.testing.assert_array_equal(r["toy/out"], ranks[0]["toy/out"])
    np.testing.assert_allclose(ranks[0]["toy/out"], ref["toy/out"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ranks[0]["toy/out"], ref["toy/seq"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("leaf", ["dw", "db"])
def test_pipeline_apply_grad_matches_jax(pipe_case, leaf):
    ranks, ref = pipe_case
    want = ref[f"toy/{leaf}"]
    for i, r in enumerate(ranks):  # rank i: stage i's slice, zeros else
        got = r[f"toy/{leaf}"]
        np.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-5)
        rest = np.delete(got, i, axis=0)
        assert not rest.any()


def test_pipelined_lm_logits_match_jax(pipe_case):
    ranks, ref = pipe_case
    got = np.concatenate([ranks[0]["logits"], ranks[2]["logits"]])
    np.testing.assert_allclose(got, ref["logits"], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(ranks[1]["logits"], ranks[0]["logits"])


def test_pipelined_lm_fit_dp_x_pp_matches_jax(pipe_case):
    """Rank (d, p) holds the outer params and stage p: both within 1e-4
    relative of the JAX Module's after the same 2 steps."""
    ranks, ref = pipe_case
    checked = 0
    for r, res in enumerate(ranks):
        stage = r % 2
        for key, got in res.items():
            if not key.startswith("params/"):
                continue
            want = ref[key]
            if key.startswith("params/stages/"):
                assert got.shape[0] == 1
                got, want = got[0], want[stage]
            assert _rel(got, want) <= 1e-4, (r, key, _rel(got, want))
            checked += 1
    assert checked == 4 * (5 + 2 * 10)  # outer, and 2 blocks a stage


def _jax_lm(seed=0):
    model = jmodels.PipelinedTransformerLM(mesh=None, **LM)
    toks = np.random.RandomState(seed).randint(0, V, (8, S))
    return model, model.init({"params": jax.random.PRNGKey(seed)},
                             jnp.asarray(toks)), toks


def test_sequential_lm_and_interchange_match_jax():
    model, v, toks = _jax_lm()
    want = np.asarray(model.apply(v, jnp.asarray(toks)))
    port = tmodels.create("transformer_lm_pipelined", device="cpu", **LM)
    load_jax_variables(port, jax.device_get(v))
    with torch.no_grad():
        got = port(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    out = flat(export_jax_variables(port)["params"], "p")
    for k, a in flat(jax.device_get(v["params"]), "p").items():
        np.testing.assert_array_equal(out[k], a)


def test_remat_stages_changes_no_gradient():
    _, v, toks = _jax_lm(1)
    grads = []
    for remat in (False, True):
        port = tmodels.create("transformer_lm_pipelined", device="cpu",
                              remat_stages=remat, **LM)
        load_jax_variables(port, jax.device_get(v))
        t = torch.from_numpy(toks)
        lm_loss(port(t), torch.roll(t, -1, 1)).backward()
        grads.append(torch.cat([p.grad.reshape(-1)
                                for p in port.parameters()]))
    assert torch.equal(grads[0], grads[1])


def test_sequential_apply_and_one_rank_pipeline():
    toy = _toy(stages=3, micro=2)
    params = {"w": torch.from_numpy(toy["w"]), "b": torch.from_numpy(toy["b"])}
    x = torch.from_numpy(toy["x_toy"])
    want = np.asarray(jsequential(_jstage, {k: jnp.asarray(v.numpy())
                                            for k, v in params.items()},
                                  jnp.asarray(toy["x_toy"])))
    np.testing.assert_allclose(sequential_apply(_tstage, params, x).numpy(),
                               want, rtol=1e-6, atol=1e-6)
    one = {k: v[:1] for k, v in params.items()}
    mesh = tmesh.make_mesh(devices=["cpu"], axis_names=("pipe", "model"))
    torch.testing.assert_close(pipeline_apply(_tstage, one, x, mesh),
                               sequential_apply(_tstage, one, x))


def test_pipeline_errors():
    mesh = tmesh.make_mesh(devices=["cpu"], axis_names=("pipe", "model"))
    toy = _toy(stages=2)
    with pytest.raises(ValueError, match="2 stages"):
        pipeline_apply(_tstage, {k: torch.from_numpy(toy[k])
                                 for k in ("w", "b")},
                       torch.from_numpy(toy["x_toy"]), mesh)
    with pytest.raises(ValueError, match="divide"):
        tmodels.create("transformer_lm_pipelined", device="cpu",
                       **dict(LM, num_stages=3))
    two = tmesh.Mesh(0, 1, None, "cpu", model=2,
                     axis_names=("data", "pipe"))
    with pytest.raises(ValueError, match="3 stages but the 'pipe' axis has "
                       "2 devices"):
        tmodels.create("transformer_lm_pipelined", device="cpu", mesh=two,
                       **dict(LM, num_stages=3, num_layers=3))
    lm = tmodels.create("transformer_lm_pipelined", device="cpu", mesh=two,
                        **dict(LM, num_micro=3))
    with pytest.raises(ValueError, match="num_micro"):
        lm(torch.zeros(8, S, dtype=torch.long))
