"""The elastic restore of the port (a checkpoint written at one world size
restored at another; ``tpuddp_torch/training/checkpoint.py``,
``tpuddp_torch/parallel/comm.py::redistribute_residual``) against the JAX
package's (``tpuddp/training/checkpoint.py:429-538, :692-741``,
``tpuddp/parallel/comm.py:744-787``), on the CPU, with inputs made from a
seed with numpy:

- ``redistribute_residual`` against the JAX function over a grid of
  ``(old, new, per)`` holding every shrink, grow and reset; the loader's
  fit of the residual (``fit_residual`` against ``_fit_leaf``) over a grid
  of worlds and padded lengths, both tags; the texts of its errors;
- files written by the JAX package's ``save_on_main`` after two bf16_ef
  steps of ``ToyMLP(hidden=(16,))`` (digits-sized inputs) on a mesh of
  ``from`` CPU devices, restored by the port at world ``to`` (each rank in
  turn, the world size and rank given to the loader) and by the JAX
  package's ``restore_latest`` at ``to``: every rank's residual, the
  parameters and the moments, and the ``topology_change`` /
  ``comm_state_reset`` rows, for (4, 2), (2, 4), (2, 1), (1, 2), (4, 3),
  (2, 3), under ZeRO-1 (4 -> 2, 2 -> 3), ``comm_topology: hierarchical``
  (4 -> 2) and a segmented run (``comm_overlap``, 4 -> 2: the guard half
  of ``tests/test_overlap.py::test_segmented_elastic_shrink_4_to_2``); a
  step snapshot restored across worlds loses its plan key in both.

Tolerance: bitwise throughout (the restore sums, moves and pads float32
rows with the JAX package's numpy arithmetic)."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from tpuddp import nn as jax_nn
from tpuddp import optim as jax_optim
from tpuddp.data import SyntheticClassification
from tpuddp.models import ToyMLP as JaxToyMLP
from tpuddp.parallel import comm as jax_comm
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.parallel.mesh import hierarchical_mesh
from tpuddp.training import checkpoint as jax_ckpt

from tpuddp_torch.models import ToyMLP
from tpuddp_torch.models.convert import flat_from_jax
from tpuddp_torch.optim import Adam, ShardedUpdate
from tpuddp_torch.parallel import comm
from tpuddp_torch.training import checkpoint as ckpt
from tpuddp_torch.training.step import make_flat_param_spec

CAP = 600 * 4 / (1024 * 1024)  # 600-element buckets: several segments
KINDS = {"flat": {}, "zero1": dict(weight_update_sharding=True),
         "hierarchical": dict(comm_topology="hierarchical"), "segmented": dict(comm_overlap=True)}
CASES = [("flat", 4, 2), ("flat", 2, 4), ("flat", 2, 1), ("flat", 1, 2), ("flat", 4, 3),
         ("flat", 2, 3), ("zero1", 4, 2), ("zero1", 2, 3), ("hierarchical", 4, 2),
         ("segmented", 4, 2)]


def _batch(n=48, seed=5):
    x, y = SyntheticClassification(n=n, shape=(8, 8, 3), seed=seed).get_batch(np.arange(n))
    return x, y, np.ones(n, np.float32)


def _jax_ddp(kind, world, devices):
    kw = dict(KINDS[kind])
    if kind == "hierarchical" and world > 1:
        mesh = hierarchical_mesh(devices=devices[:world])
    else:
        kw.pop("comm_topology", None)
        mesh = make_mesh(devices[:world])
    if world == 1:
        kw.pop("comm_overlap", None)
    return JaxDDP(JaxToyMLP(hidden=(16,)), jax_optim.Adam(1e-2), jax_nn.CrossEntropyLoss(),
                  mesh=mesh, comm_hook="bf16_ef", bucket_cap_mb=CAP, **kw)


def _like(kind, world, devices):
    x, _, _ = _batch()
    return _jax_ddp(kind, world, devices).init_state(jax.random.key(7), x[:8])


@pytest.fixture(scope="module")
def files(tmp_path_factory, cpu_devices):
    """One JAX checkpoint per (kind, from): two bf16_ef steps, then
    ``save_on_main`` at that world (a step snapshot beside it)."""
    root = tmp_path_factory.mktemp("elastic")
    out = {}
    for kind, world in sorted({(k, f) for k, f, _ in CASES}):
        ddp = _jax_ddp(kind, world, cpu_devices)
        x, _, _ = _batch()
        state = ddp.init_state(jax.random.key(0), x[:8])
        for seed in (11, 12):
            state, _ = ddp.train_step(state, ddp.shard(_batch(seed=seed)))
        if kind == "segmented":
            assert ddp.comm_overlap_meta["enabled"]
        d = root / f"{kind}_{world}"
        jax_ckpt.save_on_main(str(d), 0, state, world_size=world)
        out[kind, world] = d
    return out


def _port(kind, to, rank):
    """The port's model, optimizer and residual for rank ``rank`` of world
    ``to`` (values are the restore's to fill)."""
    torch.manual_seed(0)
    model = ToyMLP(192, 10, hidden=(16,))
    opt = Adam(model.parameters(), lr=1e-2)
    if kind == "zero1":
        spec = make_flat_param_spec(model, to)
        opt = ShardedUpdate(opt, list(model.parameters()), spec, rank=rank)
        return model, opt, torch.zeros(spec.total)
    raw = sum(p.numel() for p in model.parameters())
    return model, opt, torch.zeros(comm.make_grad_comm([raw], to, "bf16_ef").total)


def _port_restore(monkeypatch, d, kind, to, rank):
    """``restore_latest`` of ``d`` by rank ``rank`` of a world of ``to``."""
    monkeypatch.setattr(ckpt, "get_world_size", lambda: to)
    monkeypatch.setattr(ckpt, "get_rank", lambda: rank)
    monkeypatch.setattr(ckpt, "_agreed", lambda save_dir, prefix, device: ckpt._latest_any(
        save_dir, prefix))
    model, opt, residual = _port(kind, to, rank)
    log, cursors = [], []
    next_epoch, _ = ckpt.restore_latest(str(d), model, opt, comm_state=residual, reshard_log=log,
                                        model_size=1, cursor_out=cursors)
    return model, opt, residual, log, next_epoch, cursors


def _jax_leaves(tree):
    """The restored tree's arrays by key (its PRNG key leaf aside)."""
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]
            if not jax.dtypes.issubdtype(v.dtype, jax.dtypes.prng_key)}


@pytest.mark.parametrize("kind,src,to", CASES)
def test_the_port_restores_a_jax_file_as_the_jax_package_does(monkeypatch, cpu_devices, files,
                                                              kind, src, to):
    d = files[kind, src]
    jax_log = []
    restored, jax_next = jax_ckpt.restore_latest(str(d), _like(kind, to, cpu_devices),
                                                 world_size=to, reshard_log=jax_log, model_size=1)
    want = _jax_leaves(restored)
    rows = want[".comm_state"].reshape(to, -1)
    per = rows.shape[1]
    events = [e["event"] for e in jax_log]
    assert events[0] == "topology_change" and (
        ("comm_state_reset" in events) == (src % to and to % src > 0))
    for rank in range(to):
        model, opt, residual, log, next_epoch, _ = _port_restore(monkeypatch, d, kind, to, rank)
        assert (next_epoch, log) == (jax_next, jax_log)
        got = residual.numpy()
        assert got.shape == (per,)
        if kind == "zero1":  # the port keeps a ZeRO-1 residual in its own order
            raw = opt.spec.raw
            want_row = rows[rank].copy()
            want_row[:raw] = flat_from_jax("toy_mlp", model, want_row[:raw])
            np.testing.assert_array_equal(got, want_row, err_msg=f"rank {rank}")
            for slot, key in (("m", "exp_avg"), ("v", "exp_avg_sq")):
                vec = want[f".opt_state.{slot}"]
                port = np.zeros_like(vec)
                port[:raw] = flat_from_jax("toy_mlp", model, vec[:raw])
                np.testing.assert_array_equal(opt.state[opt.shard][key].numpy(),
                                              port[opt.lo:opt.hi], err_msg=f"{slot} rank {rank}")
            payload = ckpt.model_payload(ckpt.NATIVE, model)
            assert int(opt.state[opt.shard]["step"]) == int(want[".opt_state.step"])
        else:
            np.testing.assert_array_equal(got, rows[rank], err_msg=f"rank {rank}")
            payload = ckpt.state_payload(ckpt.NATIVE, model, opt)
        for k, v in payload.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    if events == ["topology_change"] and jax_log[0]["residual"] == "redistributed" and src > to:
        # a shrink: each new row the float32 sum of its group of old rows
        old = np.load(os.path.join(d, "ckpt_0.npz"))[".comm_state"].reshape(src, -1)
        assert np.any(old != 0)
        summed = old[:, :per].reshape(to, src // to, per).sum(axis=1)
        np.testing.assert_array_equal(rows, summed)


def test_a_step_snapshot_across_worlds_loses_its_plan_key(monkeypatch, cpu_devices, files,
                                                          tmp_path):
    """Both packages redo the epoch: the sampler's plan keys on the world."""
    d = tmp_path / "snap"
    shutil.copytree(files["flat", 2], d)
    restored, _ = jax_ckpt.restore_latest(str(d), _like("flat", 2, cpu_devices), world_size=2)
    jax_ckpt.save(str(d / "ckpt_1_s3.npz"), restored, meta={"epoch": 1, "completed": 0, "step": 3},
                  topology=jax_ckpt.read_topology(str(d / "ckpt_0.npz")),
                  cursor={"version": 4, "epoch": 1, "step": 3, "plan_key": "k"})
    jax_cursors = []
    jax_ckpt.restore_latest(str(d), _like("flat", 1, cpu_devices), world_size=1,
                            cursor_out=jax_cursors)
    *_, next_epoch, cursors = _port_restore(monkeypatch, d, "flat", 1, 0)
    assert next_epoch == 1 and [c["plan_key"] for c in cursors] == [
        c["plan_key"] for c in jax_cursors] == [None]
    *_, same, cursors = _port_restore(monkeypatch, d, "flat", 2, 1)
    assert same == 1 and [c["plan_key"] for c in cursors] == ["k"]


# ------------------------------------------------------------ the arithmetic --

@pytest.mark.parametrize("per", [1, 3, 8])
def test_redistribute_residual_is_the_jax_functions(per):
    rng = np.random.default_rng(per)
    for old in range(1, 7):
        mat = rng.standard_normal((old, per)).astype(np.float32)
        for new in range(1, 7):
            got, action = comm.redistribute_residual(mat, new)
            want, jax_action = jax_comm.redistribute_residual(mat, new)
            assert action == jax_action and got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            if action == "reset":
                assert old % new and new % old and not got.any()
    for bad in (np.zeros(3, np.float32), np.zeros((2, 2, 2), np.float32)):
        with pytest.raises(ValueError) as ours:
            comm.redistribute_residual(bad, 2)
        with pytest.raises(ValueError) as theirs:
            jax_comm.redistribute_residual(bad, 2)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="new_world must be >= 1"):
        comm.redistribute_residual(np.zeros((2, 2), np.float32), 0)


def _fits(stored, topo, target, world):
    """The port's and the JAX loader's fit of a ``.comm_state`` vector:
    ``(array or error text, actions)`` each."""
    out = []
    for fit in (
        lambda acts: ckpt.fit_residual("f.npz", stored, topo, target, world, acts),
        lambda acts: jax_ckpt._fit_leaf("f.npz", ".comm_state", stored,
                                        np.zeros(target, np.float32), topo, world, acts),
    ):
        actions = []
        try:
            out.append((fit(actions), actions))
        except ValueError as e:
            out.append((f"{type(e).__name__}: {e}", actions))
    return out


@pytest.mark.parametrize("raw", [5, 12])
def test_the_residuals_fit_is_the_jax_loaders(raw):
    """Every (from, to) of worlds 1-4 at ``raw`` elements a replica, both
    tags: the same array (or error) and the same actions."""
    rng = np.random.default_rng(raw)
    per = {w: w * -(-raw // w) for w in range(1, 5)}
    for src in range(1, 5):
        rows = np.zeros((src, per[src]), np.float32)
        rows[:, :raw] = rng.standard_normal((src, raw))
        tag = ({"kind": "per_replica", "world": src, "per": per[src], "model": 1} if src > 1
               else {"kind": "data_flat"})
        topo = {"world_size": src, "leaves": {".comm_state": tag}}
        for to in range(1, 5):
            (ours, our_acts), (theirs, their_acts) = _fits(rows.reshape(-1), topo, to * per[to], to)
            assert our_acts == their_acts, (src, to)
            if isinstance(theirs, str):
                assert ours == theirs, (src, to)
            else:
                np.testing.assert_array_equal(ours, theirs, err_msg=f"{src} -> {to}")


def test_the_fits_error_texts_are_the_jax_loaders():
    per_replica = {"world_size": 2, "leaves": {".comm_state": {
        "kind": "per_replica", "world": 2, "per": 6, "model": 1}}}
    tail = np.zeros((2, 6), np.float32)
    tail[1, 5] = 1.0  # past world 1's per-replica length of 5
    cases = [
        (tail.reshape(-1), per_replica, 5, 1),  # a non-zero tail
        (tail.reshape(-1), per_replica, 5, None),  # per_replica without a world size
        (np.ones(12, np.float32), None, 10, 2),  # no topology record
        (np.ones(11, np.float32), per_replica, 12, 2),  # rows that are not world x per
        (np.ones(12, np.float32), per_replica, 15, 2),  # a target that is not world x per
        (np.ones(12, np.float32), {"world_size": 2, "leaves": {}}, 10, 2),  # an untagged leaf
    ]
    for stored, topo, target, world in cases:
        (ours, _), (theirs, _) = _fits(stored, topo, target, world)
        assert isinstance(ours, str) and ours == theirs
    assert "TopologyMismatch" in _fits(*cases[0])[0][0]
    flat = np.arange(6, dtype=np.float32)
    for n_new in (3, 5, 6, 8):
        try:
            want = jax_ckpt._refit_flat("f.npz", ".opt_state.m", flat, (n_new,))
        except ValueError as e:
            with pytest.raises(ckpt.TopologyMismatch) as ours:
                ckpt._refit_flat("f.npz", ".opt_state.m", flat, n_new, None)
            assert str(ours.value) == str(e)
            continue
        np.testing.assert_array_equal(ckpt._refit_flat("f.npz", ".opt_state.m", flat, n_new, None),
                                      want)


def test_build_reshard_events_is_the_jax_packages():
    topo = {"world_size": 4, "model_size": 1}
    for world, actions, model in [
        (2, [{"leaf": ".comm_state", "action": "redistributed", "from_world": 4, "to_world": 2}], 1),
        (3, [{"leaf": ".opt_state.m", "action": "repadded", "from_shape": [8], "to_shape": [9]},
             {"leaf": ".comm_state", "action": "reset", "from_world": 4, "to_world": 3}], None),
        (4, [], 1), (2, [], None),
    ]:
        assert ckpt.build_reshard_events("d/ckpt_3.npz", 3, topo, world, actions, model) == \
            jax_ckpt.build_reshard_events("d/ckpt_3.npz", 3, topo, world, actions, model)
    assert ckpt.build_reshard_events("p", 0, None, 2, [], 1) == jax_ckpt.build_reshard_events(
        "p", 0, None, 2, [], 1) == []
