"""The port's elastic mesh on the CPU (counterpart of
``tests/test_mesh_manager.py``, whose six tests keep their names here).

Two of the JAX tests exercise what only ``jax.distributed`` has (its CPU
collectives implementation parked in a solo world); they run here against
the port's own semantics: a solo world forms no process group, and a world
that grows back forms one again, under a fresh key prefix of the store.
Beyond them: the elastic mesh job (2 -> 3 -> 2 gloo workers against the
port's scheduler, plain and with ZeRO-1 + FSDP), a share-only policy
rebalance that re-shards without a rebuild, the one-rank BN path, the
backend rule and the ZeRO/FSDP axis rule.
"""

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dt_tpu_torch import models
from dt_tpu_torch.data import io
from dt_tpu_torch.elastic import mesh_manager as mm_lib
from dt_tpu_torch.elastic.mesh_manager import (MeshManager, restore_state,
                                               snapshot_state)
from dt_tpu_torch.ops import kernels
from dt_tpu_torch.parallel import kvstore as kvlib
from dt_tpu_torch.parallel import mesh as mesh_lib
from dt_tpu_torch.parallel.zero import port_axis
from dt_tpu_torch.training.module import Module
from torch_mesh_job import elastic_job, free_port
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)


def test_snapshot_and_restore_roundtrip():
    mesh = mesh_lib.make_mesh(devices=["cpu"])
    state = {"w": torch.arange(8.0), "step": torch.tensor(3)}
    host = snapshot_state(state)
    assert isinstance(host["w"], np.ndarray)
    back = restore_state(host, mesh)
    np.testing.assert_array_equal(back["w"].numpy(), np.arange(8.0))
    assert back["w"].device == mesh.device and mesh.size == 1


def test_rebuild_single_process():
    mm = MeshManager(device="cpu")
    mesh = mm.initialize()
    state = {"w": restore_state({"w": np.ones(4, np.float32)}, mesh)["w"]}
    new_mesh, restored = mm.rebuild(state, num_processes=1, process_id=0)
    assert new_mesh.size == 1 and not dist.is_initialized()
    np.testing.assert_array_equal(restored["w"].numpy(), 1.0)
    # training continues on the new mesh
    assert float(restored["w"].sum()) == 4.0


def test_multiprocess_without_coordinator_raises():
    mm = MeshManager(device="cpu")
    with pytest.raises(ValueError, match="coordinator_address"):
        mm.initialize(num_processes=4, process_id=1)


def test_solo_rebuild_parks_and_restores_cpu_collectives(monkeypatch):
    """The port's semantics: a solo world forms no process group; growing
    back forms one again (gloo for ranks on the CPU) under the new
    generation's key prefix, where the other rank's device is read, and
    leaving it destroys it."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(
                            ("init", backend, kw["rank"], kw["world_size"])))
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda *a: calls.append(("destroy",)))
    port = free_port()
    mm = MeshManager(coordinator_address=f"127.0.0.1:{port}", device="cpu")
    assert mm.initialize(num_processes=1, process_id=0).size == 1
    assert calls == [] and mm.backend is None
    mm.teardown()
    # the other rank of the regrown world announces its device (its own
    # process would); the store's server is rank 0's, started here
    store = mm._connect(True)
    dist.PrefixStore("dt_mesh/e2/", store).set("device/1", "cpu")
    mm.initialize(num_processes=2, process_id=0, generation="e2")
    assert calls == [("init", "gloo", 0, 2)]
    assert (mm.backend, mm.backend_reason) == ("gloo",
                                               "ranks compute on the CPU")
    mm.teardown()
    assert calls[-1] == ("destroy",)


def test_restore_with_explicit_shardings():
    host = {"w": np.arange(16.0).reshape(16, 1)}
    for rank in (0, 1):
        mesh = mesh_lib.Mesh(rank, 2, device="cpu")
        out = restore_state(host, mesh,
                            shardings={"w": mesh_lib.data_sharding(mesh, 2)})
        np.testing.assert_array_equal(
            out["w"].numpy(), np.arange(16.0).reshape(16, 1)[8 * rank:
                                                             8 * rank + 8])
    solo = mesh_lib.make_mesh(devices=["cpu"])
    out = restore_state(host, solo,
                        shardings={"w": mesh_lib.data_sharding(solo, 2)})
    np.testing.assert_array_equal(out["w"].numpy(), host["w"])


class _RecordingManager(MeshManager):
    calls = []

    def rebuild(self, state, num_processes, process_id,
                coordinator_address=None, generation=None):
        type(self).calls.append((num_processes, process_id))
        mesh = mesh_lib.make_mesh(devices=["cpu"])
        return mesh, restore_state(snapshot_state(state), mesh, state=state)


def _fake_fit(num_workers_at_1=2, policy_seq_at_1=0):
    """Module.fit of a small mlp through a controller whose member count
    and policy seq change at the epoch-1 barrier."""
    class FakeController:
        rank = 0
        num_workers = 1
        policy_seq = 0

        def membership_change_barrier(self, info):
            if info.get("EPOCH_BEGIN", 0) >= 1:
                FakeController.num_workers = num_workers_at_1
                FakeController.policy_seq = policy_seq_at_1

        def publish_snapshot(self, blob):
            pass

    kv = kvlib.create("tpu_sync")
    kv.set_controller(FakeController())
    x = np.zeros((64, 4, 4, 1), np.float32)
    y = np.zeros(64, np.int32)

    def factory(parts, idx, bs):
        return io.NDArrayIter(x, y, batch_size=bs, num_parts=parts,
                              part_index=idx), None

    eit = io.ElasticDataIterator(factory, 32)
    train, _ = eit.get_data_iterator(kv)
    _RecordingManager.calls = []
    mod = Module(models.create("mlp", device="cpu", num_classes=2,
                               hidden=(4,), in_shape=(4, 4, 1)),
                 kvstore=kv, device="cpu",
                 mesh_manager=_RecordingManager(device="cpu"))
    mod.fit(train, num_epoch=2, elastic_data_iterator=eit)
    return mod


def test_module_fit_invokes_mesh_manager_on_membership_change():
    """Module.fit routes a membership change through the mesh manager
    (rebuild) before re-sharding the data, and training goes on."""
    mod = _fake_fit()
    assert _RecordingManager.calls == [(2, 0)]
    assert mod.mesh_rebuilds == 1 and mod.resharded == 1
    assert mod.state.step > 0


def test_share_only_rebalance_reshards_without_a_rebuild():
    """A policy decision alone (the seq moves, the members do not) re-shards
    the data and rebuilds nothing."""
    mod = _fake_fit(num_workers_at_1=1, policy_seq_at_1=1)
    assert _RecordingManager.calls == []
    assert mod.mesh_rebuilds == 0 and mod.resharded == 1
    assert mod.state.step == 4


@pytest.mark.parametrize("flags", [[], ["--zero", "--fsdp"]],
                         ids=["dp", "zero1_fsdp"])
def test_elastic_mesh_job_grows_and_shrinks(tmp_path, flags):
    """2 -> 3 -> 2 gloo workers of ResNet-20 (8x8) in the mesh sync mode
    against the port's scheduler: every live rank holds the same state at
    every epoch end, the joiner starts from rank 0's epoch-0 snapshot, the
    survivors rebuilt the world twice and re-sharded twice, the global
    batch split 16 / 10 / 16."""
    res, audit, launched, _ = elastic_job(str(tmp_path), [
        "--model", "resnet20", "--image-size", "8", "--device", "cpu",
        "--global-batch", "32", "--epoch-steps", "2", "--num-epoch", "3",
        "--images", "64", "--val-images", "10"] + flags, timeout=150)
    assert audit == [["ADDED", "w2"], ["REMOVED", "w2"]]
    assert launched == [("w2", 1)]
    live = {0: {"w0", "w1"}, 1: {"w0", "w1", "w2"}, 2: {"w0", "w1"}}
    for epoch, hosts in live.items():
        got = {h: e for h, r in res.items() for e in r["epochs"]
               if e["epoch"] == epoch}
        assert set(got) == hosts, epoch
        assert len({e["sha256"] for e in got.values()}) == 1, epoch
        assert {e["batch"] for e in got.values()} == \
            {32 // len(hosts)}, epoch
        assert all(e["steps"] == 2 and e["backend"] == "gloo"
                   for e in got.values())
    w0_epoch0 = res["w0"]["epochs"][0]["sha256"]
    assert res["w2"]["bootstrap"] == {"step": 2, "sha256": w0_epoch0}
    for h in ("w0", "w1"):
        assert (res[h]["mesh_rebuilds"], res[h]["resharded"]) == (2, 2)
    assert (res["w2"]["mesh_rebuilds"], res["w2"]["resharded"]) == (0, 0)
    report = res["w0"]["epochs"][1]["sharding_report"]
    assert bool(report) == bool(flags)
    # every rank scored its strided part (4/3/3 of 10) after every epoch,
    # FSDP's params gathered once for the pass
    assert all("val_acc" in e for r in res.values() for e in r["epochs"])


def test_one_rank_bn_is_the_one_device_path():
    """``cross_rank_bn`` with no group leaves training BN as it is: the
    same output, stats and gradients bit for bit."""
    rng = np.random.RandomState(0)
    x0 = rng.normal(0, 1, (4, 6, 5, 5)).astype(np.float32)
    outs = []
    for ctx in (lambda: kernels.cross_rank_bn(None), None):
        x = torch.from_numpy(x0.copy()).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        g = torch.ones(6, requires_grad=True)
        b = torch.zeros(6, requires_grad=True)
        rm, rv = torch.zeros(6), torch.ones(6)
        if ctx is None:
            y, _, _ = kernels.fused_bn_train(x, g, b, rm, rv, relu=True)
        else:
            with ctx():
                assert kernels._bn_group is None
                y, _, _ = kernels.fused_bn_train(x, g, b, rm, rv, relu=True)
        y.sum().backward()
        outs.append([y, rm, rv, x.grad, g.grad, b.grad])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_backend_follows_the_topology():
    assert mm_lib.choose_backend(["cpu", "cpu"])[0] == "gloo"
    assert mm_lib.choose_backend(["h/GPU-a", "h/GPU-b"])[0] == "nccl"
    backend, why = mm_lib.choose_backend(["h/GPU-a", "h/GPU-a"])
    assert backend == "gloo" and "NCCL refuses" in why
    assert mm_lib.choose_backend(["h/GPU-a", "cpu"])[0] == "gloo"


@pytest.mark.parametrize("shape,n,jax_axis", [
    ((3, 3, 64, 128), 2, 3), ((3, 3, 64, 64), 2, 3), ((3, 3, 64, 64), 3, 1),
    ((2048, 1000), 8, 0), ((10,), 4, None), ((), 2, None),
    ((3, 3, 3, 64), 3, 2), ((1, 1, 5, 7), 2, None)])
def test_dp_axis_is_the_jax_rule(shape, n, jax_axis):
    """The largest axis divisible by n, the last on a tie (in the JAX
    layout), and the port tensor's axis it maps to."""
    assert mesh_lib.dp_axis(shape, n) == jax_axis
    if len(shape) == 4 and jax_axis is not None:
        # HWIO axis 3 (O) is OIHW axis 0
        assert port_axis(jax_axis, "kernel", 4) == (2, 3, 1, 0)[jax_axis]
    if len(shape) == 2 and jax_axis is not None:
        assert port_axis(jax_axis, "kernel", 2) == 1 - jax_axis


def test_shard_batch_takes_this_ranks_rows():
    batch = (np.arange(12).reshape(6, 2), np.arange(6))
    parts = [mesh_lib.shard_batch(mesh_lib.Mesh(r, 3, device="cpu"), batch)
             for r in range(3)]
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]),
                                  batch[0])
    np.testing.assert_array_equal(parts[1][1], [2, 3])
    with pytest.raises(ValueError, match="equal parts"):
        mesh_lib.shard_batch(mesh_lib.Mesh(0, 4, device="cpu"), batch)


def test_model_axis_refuses_naming_item_6():
    """The model axis is ported (Queue 1 item 6): one process cannot be a
    grid of two, and a Module refuses a second axis that none of its
    model's layers uses (tensor parallelism of the dense weights, Queue 1
    item 8) or a mesh that is not a port mesh."""
    with pytest.raises(ValueError, match="not divisible by model=2"):
        mesh_lib.make_mesh(model=2)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        mesh_lib.make_mesh(data=1, model=2)
    two = mesh_lib.Mesh(0, 2, None, "cpu", model=2)
    assert two.shape == {"data": 2, "model": 2} and two.size == 4
    assert (two.axis_size("model"), two.axis_index("model")) == (2, 0)
    mlp = models.create("mlp", device="cpu", in_shape=(4, 4, 1))
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        Module(mlp, device="cpu", mesh=two)
    with pytest.raises(ValueError, match="must be 'data'"):
        Module(mlp, device="cpu", mesh=mesh_lib.Mesh(
            0, 2, None, "cpu", model=2, axis_names=("pipe", "model")))
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        Module(mlp, device="cpu",
               mesh=types.SimpleNamespace(shape={"data": 2, "model": 2}))


def test_mesh_manager_rebuild_refuses_a_model_axis():
    """``MeshManager`` forms data axes only, as the JAX package's does: a
    rebuild of a mesh with a second axis raises, naming the reason."""
    from dt_tpu_torch.elastic.mesh_manager import MeshManager
    mm = MeshManager(device="cpu")
    mm.mesh = mesh_lib.Mesh(0, 1, None, "cpu", model=2,
                            axis_names=("data", "pipe"))
    with pytest.raises(NotImplementedError, match="'pipe' axis of 2"):
        mm.rebuild({}, 1, 0)


class _ListIter:
    """Batches of the given row counts, one epoch each pass."""

    def __init__(self, rows):
        self.rows, self._i = rows, 0

    def reset(self):
        self._i = 0

    def next(self):
        if self._i == len(self.rows):
            raise StopIteration
        n = self.rows[self._i]
        self._i += 1
        return io.DataBatch(np.zeros((n, 4, 4, 1), np.float32),
                            np.zeros(n, np.int32))


@pytest.mark.parametrize("peer_rows,rows,error", [
    (8, [8, 8, 8], None), (4, [8, 8, 8], "unequal size"),
    (8, [8, 8, 4], "same rows")], ids=["equal", "unequal", "changed"])
def test_mesh_checks_equal_parts_at_an_epochs_first_step(monkeypatch,
                                                         peer_rows, rows,
                                                         error):
    """The equal-parts check is one collective and one host read at each
    epoch's first mesh step; a later batch of other rows raises without a
    collective.  The second rank is simulated: it holds ``peer_rows`` rows
    and the gradient it adds equals this rank's."""
    checks = []

    def all_reduce(t, group=None, **kw):
        if t.dtype == torch.float64:  # the check's [rows, rows^2]
            checks.append(int(t[0]))
            t.add_(torch.tensor([peer_rows, peer_rows ** 2], dtype=t.dtype))
        else:
            t.mul_(2)
    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    mod = Module(models.create("mlp", device="cpu", num_classes=2,
                               hidden=(4,), in_shape=(4, 4, 1)),
                 device="cpu", mesh=mesh_lib.Mesh(0, 2, device="cpu"))
    if error is None:
        mod.fit(_ListIter(rows), num_epoch=2)
        assert checks == [8, 8] and mod.state.step == 6
    else:
        with pytest.raises(ValueError, match=error):
            mod.fit(_ListIter(rows), num_epoch=2)
        assert checks == [8]
