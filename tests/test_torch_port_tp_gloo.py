"""Tensor parallelism of the port on Gloo worlds of 4 (2 x 2) and 2 (1 x 2)
processes against the JAX package's TP wrap on a ``(data, model)`` mesh of
CPU devices.

``transformer_tiny`` at V 64, T 32, global batch 8, from one JAX init. The
port side is ``tests/_torch_port_tp_worker.py``: each world started once
(module fixture; both run while the JAX side computes), its jobs through
the native entry point's ``build_training`` with ``parallel: {model: 2}``.
The JAX side is ``DistributedDataParallel(mesh=mesh2d(D, 2))`` in this
process, as ``tests/test_mesh2d.py`` runs it.

Tolerances: the forward within rtol 1e-4 / atol 1e-5 (the port-vs-JAX
bound of the transformers); one Adam step's whole parameters within 5e-4
a leaf (``tests/test_mesh2d.py:253-280``), or, where the JAX package's own
step from an init one ulp higher moves a leaf by more (the key
projection's bias, whose exact gradient is 0), within 4 times that move;
6 step losses within 1e-4 of the JAX TP run and of the port's own data-4
model-1 run; the K-step chunk, the firewall's skip, the model-1 identity,
the checkpoints and the bf16 rounding of a weight-decay-only step bitwise.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from tpuddp import optim as jax_optim
from tpuddp.models import load_model as jax_load_model
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel import tensor as jax_tp
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.parallel.mesh import DATA_AXIS
from tpuddp.parallel.mesh2d import mesh2d as jax_mesh2d
from tpuddp.training import checkpoint as jax_ckpt
from tpuddp.utils.compat import shard_map

from tpuddp_torch import config as cfg
from tpuddp_torch.models.convert import state_dict_from_jax, torch_layout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 300
NAME, V, T, B, LR, STEPS, K = "transformer_tiny", 64, 32, 8, 1e-2, 6, 3
FWD_RTOL, FWD_ATOL, STEP_ATOL, LOSS_ATOL, SPREAD, WD = 1e-4, 1e-5, 5e-4, 1e-4, 4.0, 0.1
WORLDS = {4: (2, 2), 2: (1, 2)}
TRAINING = dict(cfg.TRAINING_DEFAULTS, model=NAME, num_classes=V, learning_rate=LR, seed=0,
                dataset="synthetic_tokens")
LOADERS = dict(vocab=V, seq_len=T, global_batch=B, n_batches=2)
TP = {"model": 2}
AUDIT_PARAM = "blocks.0.mlp.fc1.weight"  # split over the model axis


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree):
    """A canonical JAX tree in the port's layout, by parameter name."""
    return {k: np.asarray(v) for k, v in torch_layout(NAME, tree).items()}


def _jobs(world):
    """Both worlds: the forward, 6 steps, a K-step chunk, the guard, a
    bf16_ef save and its refusal at model 1, the loop's periodic audit.
    World 4 besides: the port's own data-4 run, model 1 against no parallel
    block, the JAX checkpoint's restore; world 2: the bf16 moments."""
    jobs = [
        dict(name="fwd", kind="forward", parallel=TP),
        dict(name="steps", kind="steps", parallel=TP),
        dict(name="many", kind="many", parallel=TP, batches="chunk.npz"),
        dict(name="guard", kind="guard", parallel=TP, training=dict(TRAINING, guard=True)),
        dict(name="ef", kind="save", parallel=TP, training=dict(TRAINING, comm_hook="bf16_ef")),
        dict(name="refuse", kind="load", dir="ef", training=dict(TRAINING, comm_hook="bf16_ef")),
    ]
    if world == 4:
        jobs += [dict(name="dp", kind="steps", parallel=None),
                 dict(name="model1", kind="steps", parallel={"model": 1}),
                 dict(name="load_jax", kind="load", dir="jax_ckpt", parallel=TP,
                      training=dict(TRAINING, comm_hook="bf16_ef"))]
    else:
        jobs.append(dict(name="bf16", kind="steps", parallel=TP, batches="zero_w.npz",
                         training=dict(TRAINING, weight_decay=WD, optimizer_state_dtype="bfloat16")))
    # last: its second loop ends in ReplicaDesync on every rank
    jobs.append(dict(name="audit", kind="audit", parallel=TP, param=AUDIT_PARAM,
                     corrupt=[world - 1, 1.0 if world == 4 else float("nan")],
                     training=dict(TRAINING, guard={"audit_every_n_epochs": 1})))
    for job in jobs:
        job.setdefault("training", TRAINING)
        job["loaders"] = LOADERS
    return jobs


def _batches(seed, n, zero_w=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, V, (n, B, T)).astype(np.int32)
    y = rng.integers(0, V, (n, B, T)).astype(np.int32)
    w = np.zeros((n, B, T), np.float32) if zero_w else np.ones((n, B, T), np.float32)
    return dict(x=x, y=y, w=w)


def _jax_ddp(devices, world, **kw):
    data, model = WORLDS[world]
    optimizer = kw.pop("optimizer", None) or jax_optim.Adam(LR)
    return JaxDDP(jax_load_model(NAME, num_classes=V), optimizer, JaxCrossEntropyLoss(),
                  mesh=jax_mesh2d(data, model, devices=devices[:world]), **kw)


def _init_state(ddp, params):
    return ddp.init_state(jax.random.key(0), jnp.zeros((1, T), jnp.int32), params=params,
                          model_state=())


def _loss(m):
    return float(np.asarray(m["loss_sum"]).sum() / np.asarray(m["n"]).sum())


def _jax_side(devices, world, init, up, batches, work):
    """The JAX references of one world (a generator: the first part before
    the port's worker starts). World 4 writes a checkpoint of one bf16_ef
    step into ``work/jax_ckpt``, which the port's ``load_jax`` job reads."""
    out = {}
    ddp = _jax_ddp(devices, world, comm_hook="bf16_ef")
    st = _init_state(ddp, init)
    out["bytes"] = (ddp.grad_comm_bytes_per_step, ddp.grad_comm_bytes_per_step_f32)
    out["residual_shape"] = (world, ddp._comm.spec.total)
    if world == 4:
        st, _ = ddp.train_step(st, ddp.shard(batches[0]))
        jax_ckpt.save_on_main(str(work / "jax_ckpt"), 0, st, world_size=world)
        out["jax_ckpt"] = _port(jax_tp.gather_params(st))
        out["jax_ckpt_m"] = _port(jax_tp.from_tp_tree(_np(st.opt_state.m)))
        out["jax_ckpt_residual"] = np.asarray(st.comm_state).reshape(world, -1)
    out["ckpt_template"] = st
    yield out  # the port's worker starts here

    ddp = _jax_ddp(devices, world)
    st = _init_state(ddp, init)
    fwd = shard_map(lambda p, t: jax_tp.tp_forward(ddp.model, p, t), mesh=ddp.mesh,
                    in_specs=(ddp.tp_param_specs, P(DATA_AXIS)), out_specs=P(DATA_AXIS),
                    check_vma=False)
    out["logits"] = np.asarray(jax.jit(fwd)(st.params, ddp.shard((batches[0][0],))[0]))
    losses = []
    for i, b in enumerate(batches):
        st, m = ddp.train_step(st, ddp.shard(b))
        losses.append(_loss(m))
        if i == 0:
            out["step1"] = _port(jax_tp.gather_params(st))
    out["losses"] = np.asarray(losses)
    st_up, _ = ddp.train_step(_init_state(ddp, up), ddp.shard(batches[0]))
    out["step1_up"] = _port(jax_tp.gather_params(st_up))
    if world == 2:
        ddp = _jax_ddp(devices, world, optimizer=jax_optim.Adam(LR, weight_decay=WD,
                                                                  state_dtype="bfloat16"))
        zero = _batches(7, 1, zero_w=True)
        st, _ = ddp.train_step(_init_state(ddp, init), ddp.shard(tuple(zero[k][0] for k in "xyw")))
        out["bf16"] = {slot: _port(jax_tp.from_tp_tree(jax.tree_util.tree_map(
            lambda a: np.asarray(a).view(np.uint16), _np(getattr(st.opt_state, slot)))))
            for slot in ("m", "v")}
    yield out


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    for var in ("TPUDDP_WORLD_SIZE", "TPUDDP_MODEL_SIZE", "TPUDDP_FAULT", "TPUDDP_AUTO_RESUME"):
        env.pop(var, None)
    return env


@pytest.fixture(scope="module")
def init():
    params, _ = jax_load_model(NAME, num_classes=V).init(jax.random.key(3),
                                                         jnp.zeros((1, T), jnp.int32))
    params = _np(params)
    return params, jax.tree_util.tree_map(lambda p: np.nextafter(p, np.inf).astype(p.dtype), params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cpu_devices, init):
    """Both worlds' port runs and JAX references: ``{world: (workdir,
    jax)}``."""
    params, up = init
    batches = _batches(0, STEPS)
    steps = [tuple(batches[k][i] for k in "xyw") for i in range(STEPS)]
    works, sides, procs = {}, {}, {}
    for world in WORLDS:  # both worlds run while the JAX side computes
        work = tmp_path_factory.mktemp(f"tp_world{world}")
        np.savez(work / "init.npz", **{k: v.numpy() for k, v in state_dict_from_jax(NAME, params).items()})
        np.savez(work / "batches.npz", **batches)
        np.savez(work / "chunk.npz", **{k: v[:K] for k, v in batches.items()})
        np.savez(work / "zero_w.npz", **_batches(7, 1, zero_w=True))
        (work / "jobs.json").write_text(json.dumps(_jobs(world)))
        procs[world] = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "_torch_port_tp_worker.py"), str(work),
             str(world)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env())
        works[world] = work
    try:
        refs = {}
        for world in WORLDS:  # world 4's JAX checkpoint first: its worker waits for it
            side = _jax_side(cpu_devices, world, params, up, steps, works[world])
            next(side)
            sides[world] = side
        for world, side in sides.items():
            refs[world] = next(side)
        for world, proc in procs.items():
            _, err = proc.communicate(timeout=SPAWN_TIMEOUT_S)
            assert proc.returncode == 0, err[-4000:]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    yield {world: (works[world], refs[world]) for world in WORLDS}
    for work in works.values():
        shutil.rmtree(work)


def _load(work, name):
    with np.load(work / f"{name}.npz") as data:
        return dict(data.items())


def _within(got, ref, up, atol, err_msg):
    err = np.abs(np.asarray(got, np.float64) - ref)
    if err.max() <= atol:
        return
    spread = np.abs(np.asarray(up, np.float64) - ref).max()
    assert spread > atol and err.max() <= SPREAD * spread, (err_msg, float(err.max()), float(spread))


@pytest.mark.parametrize("world", list(WORLDS))
def test_forward_matches_the_jax_tp_forward(runs, world):
    work, jax_ref = runs[world]
    logits = _load(work, "fwd")["logits"]  # (world, B / D, T, V): each rank's
    data, model = WORLDS[world]
    rows = B // data
    for rank in range(world):
        d = rank // model
        np.testing.assert_allclose(logits[rank], jax_ref["logits"][d * rows:(d + 1) * rows],
                                   rtol=FWD_RTOL, atol=FWD_ATOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("world", list(WORLDS))
def test_one_adam_step_matches_the_jax_tp_step(runs, world):
    work, jax_ref = runs[world]
    got = _load(work, "steps")
    for name, ref in jax_ref["step1"].items():
        _within(got[f"step1/{name}"], ref, jax_ref["step1_up"][name], STEP_ATOL, name)


@pytest.mark.parametrize("world", list(WORLDS))
def test_six_step_losses_match_the_jax_tp_run(runs, world):
    work, jax_ref = runs[world]
    np.testing.assert_allclose(_load(work, "steps")["losses"], jax_ref["losses"], rtol=0,
                               atol=LOSS_ATOL)


def test_six_step_losses_match_the_ports_data_4_run(runs):
    work, _ = runs[4]
    np.testing.assert_allclose(_load(work, "steps")["losses"], _load(work, "dp")["losses"],
                               rtol=0, atol=LOSS_ATOL)


@pytest.mark.parametrize("world", list(WORLDS))
def test_the_k_step_chunk_is_k_single_steps(runs, world):
    got = _load(runs[world][0], "many")
    names = [k[len("many/"):] for k in got if k.startswith("many/")]
    assert len(names) == 28
    for name in names:
        np.testing.assert_array_equal(got[f"many/{name}"], got[f"single/{name}"], err_msg=name)


@pytest.mark.parametrize("world", list(WORLDS))
def test_eval_counts_every_token_and_collectives_per_step(runs, world):
    got = _load(runs[world][0], "steps")
    loss_sum, correct, n = got["eval"]
    assert n == B * T and np.isfinite(loss_sum) and 0 <= correct <= n
    # transformer_tiny's 2 blocks: 1 + 2 * 2 + 1 forward, 2 * 2 + 1 backward
    assert got["collectives"].tolist() == [6 * STEPS, 5 * STEPS, 0]


@pytest.mark.parametrize("world", list(WORLDS))
def test_the_guard_has_no_false_positive_and_a_skip_is_a_no_op(runs, world):
    got = _load(runs[world][0], "guard")
    names = [k[len("before/"):] for k in got if k.startswith("before/")]
    for name in names:
        np.testing.assert_array_equal(got[f"skipped/{name}"], got[f"before/{name}"], err_msg=name)
    assert got["after_skip"].tolist() == [1, 1] and got["after_clean"].tolist() == [1, 0]
    assert any(not np.array_equal(got[f"clean/{n}"], got[f"before/{n}"]) for n in names)


@pytest.mark.parametrize("world", list(WORLDS))
def test_the_loops_audit_compares_data_replicas_and_every_rank_agrees(runs, world):
    """``run_training_loop`` with ``guard: {audit_every_n_epochs: 1}`` at
    model 2: two epochs of shards that differ across the model axis by
    design write no desync row. One element of the last rank's shard
    changed (a finite offset at 2 x 2, where only its data replica can see
    it; a NaN at 1 x 2) is then the ``ReplicaDesync`` of that leaf on every
    rank, rank 0's included, and rank 0's one desync row."""
    work = runs[world][0]
    got = _load(work, "audit")
    path = str(got["path"])
    assert path == "['blocks'][0]['mlp']['w1']"
    assert got["raised"].tolist() == [path] * world
    with open(work / "audit" / "history.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [r["epoch"] for r in lines if "train_loss" in r] == [0, 1]
    assert [(r["epoch"], r["leaf"]) for r in lines if r.get("event") == "desync"] == [(0, path)]


def _bf16_neighbours(x32):
    bits = np.ascontiguousarray(x32, np.float32).view(np.uint32)
    down = bits & np.uint32(0xFFFF0000)
    up = np.where((bits & np.uint32(0xFFFF)) == 0, down, down + np.uint32(0x10000))
    return (down >> 16).astype(np.uint16), (up >> 16).astype(np.uint16)


@pytest.mark.parametrize("world", [2])
def test_bf16_moments_round_as_the_jax_tp_step(runs, world, init):
    """A weight-decay-only step (every token weighted 0: both packages'
    gradient is ``WD * p`` exactly): each local shard's moments rounded with
    the Weyl noise over its own elements, salted by the JAX leaf index.
    Vectors and tables (the JAX element order) bitwise; a projection's
    weight (transposed) a bf16 neighbour of its float32 moment."""
    work, jax_ref = runs[world]
    got = _load(work, "bf16")
    p = _port(init[0])
    for slot, key, scale in (("m", "exp_avg", 0.1), ("v", "exp_avg_sq", 0.001)):
        for name, ref in jax_ref["bf16"][slot].items():
            mine = got[f"{key}/{name}"].view(np.uint16)
            if mine.ndim == 1 or name in ("embed.weight", "pos.weight"):
                np.testing.assert_array_equal(mine, ref, err_msg=f"{name} {slot}")
            else:
                g = (np.float32(WD) * p[name]).astype(np.float32)
                f32 = np.float32(scale) * (g if slot == "m" else g * g)
                down, up = _bf16_neighbours(f32)
                assert ((mine == down) | (mine == up)).all(), f"{name} {slot}"


@pytest.mark.parametrize("world", list(WORLDS))
def test_ef_residual_per_rank_and_bytes_over_the_data_axis(runs, world):
    work, jax_ref = runs[world]
    got = _load(work, "ef")
    residual = got["residual"]
    assert residual.shape == jax_ref["residual_shape"]  # (world, per): (data, model) rows
    assert all(np.any(r != 0) for r in residual)
    assert not np.array_equal(residual[0], residual[1])  # each model shard its own
    with np.load(work / "ef" / "ckpt_0.npz") as f:
        topo = json.loads(str(f["__topology__"]))
    assert topo["leaves"][".comm_state"] == {"kind": "per_replica", "world": world,
                                             "per": residual.shape[1], "model": 2}
    # one exchange's wire bytes of the LOCAL shard over the data axis: the
    # JAX TP wrap's, with the hook and in float32
    assert got["bytes"].tolist() == list(jax_ref["bytes"])
    assert _load(work, "steps")["bytes"][1] == jax_ref["bytes"][1]


@pytest.mark.parametrize("world", [4])
def test_a_port_tp_checkpoint_loads_in_the_jax_tp_wrap(runs, world):
    work, jax_ref = runs[world]
    path = str(work / "ef" / "ckpt_0.npz")
    template = jax_ref["ckpt_template"]
    state = jax_ckpt.load(path, template, world_size=world, model_size=2)
    saved = _load(work, "ef")
    for name, arr in _port(jax_tp.gather_params(state)).items():
        np.testing.assert_array_equal(arr, saved[name], err_msg=name)
    m = _port(jax_tp.from_tp_tree(_np(state.opt_state.m)))
    for name, arr in m.items():
        np.testing.assert_array_equal(arr, saved[f"exp_avg/{name}"], err_msg=name)
    np.testing.assert_array_equal(np.asarray(state.comm_state).reshape(world, -1), saved["residual"])
    jax_topo = jax_ckpt.read_topology(str(work / "jax_ckpt" / "ckpt_0.npz"))
    assert jax_ckpt.read_topology(path) == jax_topo


@pytest.mark.parametrize("world", [4])
def test_a_jax_tp_checkpoint_loads_in_the_port(runs, world):
    work, jax_ref = runs[world]
    got = _load(work, "load_jax")
    assert int(got["step"]) == 1
    for name, arr in jax_ref["jax_ckpt"].items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    for name, arr in jax_ref["jax_ckpt_m"].items():
        np.testing.assert_array_equal(got[f"exp_avg/{name}"], arr, err_msg=name)
    np.testing.assert_array_equal(got["residual"], jax_ref["jax_ckpt_residual"])


@pytest.mark.parametrize("world", list(WORLDS))
def test_another_model_width_is_the_typed_refusal(runs, world):
    work, jax_ref = runs[world]
    refused = str(_load(work, "refuse")["refused"])
    path = str(work / "ef" / "ckpt_0.npz")
    with pytest.raises(jax_ckpt.TopologyMismatch) as err:
        jax_ckpt.load(path, jax_ref["ckpt_template"], world_size=world, model_size=1)
    assert refused == str(err.value) and "model=2 mesh" in refused


def test_model_1_is_bitwise_the_run_without_the_block(runs):
    """``parallel: {model: 1}`` at world 4 takes the unchanged data-parallel
    path: every loss, parameter, moment and eval sum bitwise the run
    without a ``parallel`` block (the port's counterpart of
    ``tests/test_mesh2d.py:322-349``'s HLO identity)."""
    work, _ = runs[4]
    one, none = _load(work, "model1"), _load(work, "dp")
    assert sorted(one) == sorted(none)
    for key in one:
        np.testing.assert_array_equal(one[key], none[key], err_msg=key)
