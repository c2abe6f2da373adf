"""Checkpoints of the port in the JAX package's layout, on the CPU: files the
JAX package writes restore into the port and files the port writes restore
into the unchanged JAX package (``ckpt_{epoch}.npz``, ``state_{epoch}.npz``,
``model.npz``; toy_mlp and toy_cnn here, AlexNet in
tests/test_torch_port_resume_alexnet.py; float32 and bf16 moments), and the
file handling of a run directory. Resume continuity is in
tests/test_torch_port_resume_continuity.py.

Tolerance: bitwise throughout (the layouts only move elements)."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpuddp import optim as jax_optim
from tpuddp.accelerate import Accelerator as JaxAccelerator
from tpuddp.models import load_model as jax_load_model
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.optim import AdamState
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.resilience import integrity as jax_integrity
from tpuddp.training import checkpoint as jax_ckpt

from tpuddp_torch.accelerate import Accelerator
from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import (
    jax_from_state_dict, jax_leaf_index, model_name, state_dict_from_jax, torch_layout,
)
from tpuddp_torch.optim import Adam
from tpuddp_torch.seeding import jax_run_key
from tpuddp_torch.training import checkpoint as ckpt

HW = {"toy_mlp": 8, "toy_cnn": 8, "alexnet": 64}
MOMENTS = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    jax.tree_util.tree_map(lambda u, v: np.testing.assert_array_equal(_bits(u), _bits(v)), a, b)


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """The JAX package's own init of ``name`` (AlexNet's takes seconds, so
    each model is initialised once per module)."""
    return _np(jax_load_model(name, 10).init(jax.random.PRNGKey(1),
                                             jnp.zeros((1, HW[name], HW[name], 3))))


def _jax_state(name, moments, cpu_devices, step=5):
    """A JAX TrainState of ``name`` whose moments are random (non-zero) in
    the ``moments`` dtype, at Adam step ``step``."""
    params, mstate = _jax_init(name)
    ddp = JaxDDP(jax_load_model(name, 10), jax_optim.Adam(state_dtype=moments),
                 JaxCrossEntropyLoss(), mesh=make_mesh(cpu_devices[:1]))
    state = ddp.init_state(jax.random.key(1), jnp.zeros((1, HW[name], HW[name], 3)),
                           params=params, model_state=mstate)
    rng = np.random.default_rng(2)
    rand = lambda p, scale: (rng.standard_normal(p.shape, np.float32) * scale).astype(MOMENTS[moments])
    opt = AdamState(
        step=np.int32(step),
        m=jax.tree_util.tree_map(lambda p: rand(p, 1e-2), state.params),
        v=jax.tree_util.tree_map(lambda p: np.abs(rand(p, 1e-3)), state.params),
    )
    return dataclasses.replace(state, opt_state=opt)


def _port(name, moments="float32"):
    model = load_model(name, 10, input_shape=(HW[name], HW[name], 3))
    leaf = jax_leaf_index(name, model)
    opt = Adam(model.parameters(), lr=1e-2, state_dtype=moments,
               leaf_index=[leaf[n] for n, _ in model.named_parameters()])
    return model, opt


def _assert_port_holds(name, model, opt, params, mstate, opt_state):
    """The port's model and Adam hold the JAX trees bitwise."""
    want = state_dict_from_jax(name, _np(params), _np(mstate))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    m, v = (torch_layout(name, [{k: _bits(a) for k, a in layer.items()} if layer else ()
                                for layer in _np(tree)]) for tree in (opt_state.m, opt_state.v))
    bits = lambda t: t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()
    for pname, p in model.named_parameters():
        state = opt.state[p]
        assert state["step"] == int(opt_state.step)
        assert state["exp_avg"].dtype == opt.state_dtype and state["exp_avg"].is_contiguous()
        np.testing.assert_array_equal(bits(state["exp_avg"]), m[pname])
        np.testing.assert_array_equal(bits(state["exp_avg_sq"]), v[pname])


def _train_port(model, opt, steps=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    hw = HW[model_name(model)]
    for _ in range(steps):
        model.train()(torch.randn(3, hw, hw, 3, generator=gen)).square().mean().backward()
        opt.step()
        opt.zero_grad()


# AlexNet's cases (684 MB files) run from tests/test_torch_port_resume_alexnet.py,
# so that a second test worker takes them
CASES = [(n, m) for n in ("toy_mlp", "toy_cnn") for m in ("float32", "bfloat16")]


# ----------------------------------------------------------- JAX -> port ----

@pytest.mark.parametrize("name,moments", CASES)
def test_jax_ckpt_restores_into_the_port_bitwise(tmp_path, cpu_devices, name, moments):
    state = _jax_state(name, moments, cpu_devices)
    jax_ckpt.save_on_main(str(tmp_path), 0, state, world_size=1)
    model, opt = _port(name, moments)
    assert ckpt.restore_latest(str(tmp_path), model, opt)[0] == 1
    _assert_port_holds(name, model, opt, state.params, state.model_state, state.opt_state)


@pytest.mark.parametrize("name,moments", CASES)
def test_jax_state_and_model_files_restore_into_the_port_bitwise(tmp_path, cpu_devices, name, moments):
    """state_0.npz and model.npz as the JAX Accelerator writes them: through
    ``save_state``/``save_model`` for the toy models; for AlexNet the same
    trees through the same writer (``save_on_main(prefix="state")`` and
    ``save``, tpuddp/accelerate.py:1566, 1709), without compiling AlexNet."""
    state = _jax_state(name, moments, cpu_devices)
    if name == "alexnet":
        key = jax.random.key(4)
        tree = {"params": state.params, "model_state": state.model_state,
                "opt_state": state.opt_state, "rng_key": key, "bwd_key": key,
                "bwd_counter": np.asarray(7, np.int64)}
        jax_ckpt.save_on_main(str(tmp_path), 0, tree, prefix="state", world_size=1)
        jax_ckpt.save(str(tmp_path / "model.npz"),
                      {"params": state.params, "model_state": state.model_state})
    else:
        module = jax_load_model(name, 10)
        module._tpuddp_initial_variables = (state.params, state.model_state)
        acc = JaxAccelerator(mesh=make_mesh(cpu_devices[:1]), seed=0)
        jmodel, jopt = acc.prepare(module, jax_optim.Adam(state_dtype=moments))
        jmodel(jnp.zeros((1, HW[name], HW[name], 3)))
        jopt.opt_state = state.opt_state
        acc.save_model(jmodel, str(tmp_path))
        acc.save_state(jmodel, jopt, str(tmp_path), epoch=0)
    model, opt = _port(name, moments)
    acc = Accelerator(seed=0, device="cpu")
    pmodel, popt = acc.prepare(model, opt)
    assert acc.load_state(pmodel, popt, str(tmp_path)) == 1
    _assert_port_holds(name, model, opt, state.params, state.model_state, state.opt_state)
    _train_port(model, opt, steps=1)
    acc.load_model(pmodel, str(tmp_path))
    want = state_dict_from_jax(name, _np(state.params), _np(state.model_state))
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    assert not opt.state  # load_model restarts the moments, tpuddp/accelerate.py:1599-1607


# ----------------------------------------------------------- port -> JAX ----

@pytest.mark.parametrize("name,moments", CASES)
def test_port_ckpt_restores_into_the_jax_package_bitwise(tmp_path, cpu_devices, name, moments):
    model, opt = _port(name, moments)
    _train_port(model, opt)
    path = ckpt.save_on_main(str(tmp_path), 3, model, opt, rank=0, seed=2**33 + 9, step=2)
    assert jax_integrity.verify_file(path) and jax_ckpt.read_meta(path) == {"epoch": 3, "completed": 1}
    like = _jax_state(name, moments, cpu_devices, step=0)
    restored, next_epoch = jax_ckpt.restore_latest(str(tmp_path), like, world_size=1)
    assert next_epoch == 4 and jax_ckpt.read_topology(path)["world_size"] == 1
    params, mstate = jax_from_state_dict(name, model.state_dict())
    _assert_trees_equal(_np(restored.params), params)
    _assert_trees_equal(_np(restored.model_state), mstate)
    assert int(restored.opt_state.step) == int(restored.step) == 2
    run_key = jax.random.split(jax.random.fold_in(jax.random.key((2**33 + 9) % 2**63), 0))[1]
    np.testing.assert_array_equal(jax.random.key_data(restored.rng), jax.random.key_data(run_key))
    _assert_port_holds(name, model, opt, restored.params, restored.model_state, restored.opt_state)


@pytest.mark.parametrize("name", ["toy_mlp", "toy_cnn"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_port_state_and_model_files_restore_into_the_jax_accelerator(tmp_path, cpu_devices, name, moments):
    model, opt = _port(name, moments)
    acc = Accelerator(seed=0, device="cpu")
    pmodel, popt = acc.prepare(model, opt)
    _train_port(model, opt)
    acc.save_model(pmodel, str(tmp_path))
    acc.save_state(pmodel, popt, str(tmp_path), epoch=2)
    for f in ("model.npz", "state_2.npz"):
        assert jax_integrity.verify_file(str(tmp_path / f))

    jacc = JaxAccelerator(mesh=make_mesh(cpu_devices[:1]), seed=5)
    jmodel, jopt = jacc.prepare(jax_load_model(name, 10), jax_optim.Adam(state_dtype=moments))
    jmodel(jnp.zeros((1, HW[name], HW[name], 3)))
    assert jacc.load_state(jmodel, jopt, str(tmp_path)) == 3
    params, mstate = jax_from_state_dict(name, model.state_dict())
    _assert_trees_equal(_np(jmodel.params), params)
    _assert_trees_equal(_np(jmodel.model_state), mstate)
    _assert_port_holds(name, model, opt, jmodel.params, jmodel.model_state, jopt.opt_state)
    jacc.load_model(jmodel, str(tmp_path))
    _assert_trees_equal(_np(jmodel.params), params)
    assert jopt.opt_state is None


@pytest.mark.parametrize("name", ["toy_mlp", "toy_cnn"])
def test_round_trips_through_the_bridge_are_bitwise(cpu_devices, name):
    params, mstate = _jax_init(name)
    sd = state_dict_from_jax(name, params, mstate)
    back = jax_from_state_dict(name, sd)
    _assert_trees_equal(back, (params, mstate))
    again = state_dict_from_jax(name, *back)
    assert all(torch.equal(again[k], sd[k]) for k in sd)


# ------------------------------------------------------- file handling -----

def _saved_run(tmp_path, epochs, keep_last=None):
    model, opt = _port("toy_mlp")
    for epoch in range(epochs):
        _train_port(model, opt, steps=1, seed=epoch)
        ckpt.save_on_main(str(tmp_path), epoch, model, opt, rank=0, keep_last=keep_last,
                          step=epoch + 1)
    return model, opt


def _names(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".npz"))


def test_keep_last_prunes_and_keeps_the_newest_full_epoch(tmp_path, cpu_devices):
    _saved_run(tmp_path, 5, keep_last=2)
    assert _names(tmp_path) == ["ckpt_3.npz", "ckpt_4.npz"]
    assert not (tmp_path / "ckpt_2.npz.sha256").exists()
    # a newer step snapshot outranks them, but the newest intact full-epoch
    # file is never collected
    state = _jax_state("toy_mlp", "float32", cpu_devices)
    jax_ckpt.save_on_main(str(tmp_path), 5, state, step=3, cursor={"epoch": 5, "step": 3},
                          world_size=1)
    (tmp_path / "ckpt_2.npz.tmp").write_bytes(b"torn")
    assert ckpt.prune_checkpoints(str(tmp_path), 1) == 1
    assert _names(tmp_path) == ["ckpt_4.npz", "ckpt_5_s3.npz"]
    assert not (tmp_path / "ckpt_2.npz.tmp").exists()


def test_a_corrupt_newest_file_is_skipped(tmp_path):
    model, opt = _saved_run(tmp_path, 2)
    with open(tmp_path / "ckpt_1.npz", "r+b") as f:
        f.truncate(1000)
    assert not ckpt.verify_file(str(tmp_path / "ckpt_1.npz"))
    restored, ropt = _port("toy_mlp")
    assert ckpt.restore_latest(str(tmp_path), restored, ropt)[0] == 1  # from ckpt_0
    with np.load(tmp_path / "ckpt_0.npz") as data:
        assert int(data[".step"]) == 1
    assert all(s["step"] == 1 for s in ropt.state.values())


def test_verify_file_has_the_jax_semantics(tmp_path):
    _saved_run(tmp_path, 1)
    path = str(tmp_path / "ckpt_0.npz")
    assert ckpt.verify_file(path) and jax_integrity.verify_file(path)
    os.remove(path + ".sha256")
    assert ckpt.verify_file(path) and not ckpt.verify_file(path, require_manifest=True)
    (tmp_path / "empty.npz").write_bytes(b"")
    (tmp_path / "junk.npz").write_bytes(b"not a zip")
    for p in ("empty.npz", "junk.npz", "missing.npz"):
        assert ckpt.verify_file(str(tmp_path / p)) == jax_integrity.verify_file(str(tmp_path / p)) is False
    with open(path, "r+b") as f:
        f.seek(200)
        f.write(b"\x00\x01\x02\x03")
    ckpt.write_manifest(path)
    with open(path, "r+b") as f:
        f.seek(300)
        f.write(b"\x07")
    assert not ckpt.verify_file(path) and not jax_integrity.verify_file(path)


def test_an_emergency_jax_save_redoes_its_epoch(tmp_path, cpu_devices):
    state = _jax_state("toy_cnn", "float32", cpu_devices)
    jax_ckpt.save_on_main(str(tmp_path), 4, state, completed=False, world_size=1)
    model, opt = _port("toy_cnn")
    assert ckpt.restore_latest(str(tmp_path), model, opt) == (
        4, {"epoch": 4, "completed": 0, "step": 0})
    assert ckpt.read_meta(str(tmp_path / "ckpt_4.npz")) == {"epoch": 4, "completed": 0}


def test_unported_contents_are_refused(tmp_path, cpu_devices):
    state = _jax_state("toy_mlp", "float32", cpu_devices)
    model, opt = _port("toy_mlp")
    # a step snapshot's data cursor is ported (tests/test_torch_port_snapshot.py):
    # the file restores and its cursor comes back, as the JAX package's does
    jax_ckpt.save_on_main(str(tmp_path / "a"), 0, state, step=3, cursor={"epoch": 0, "step": 3},
                          world_size=1)
    cursors = []
    assert ckpt.restore_latest(str(tmp_path / "a"), model, opt, cursor_out=cursors)[0] == 0
    assert [(c["epoch"], c["step"], c["provenance"]) for c in cursors] == [(0, 3, "local")]
    os.makedirs(tmp_path / "b")
    # ZeRO-1's data_flat moments are ported: into per-parameter Adam they
    # are the JAX package's missing leaf (tests/test_torch_port_zero1_ckpt.py)
    flat = dataclasses.replace(state, opt_state=AdamState(
        step=np.int32(5), m=np.zeros(1000, np.float32), v=np.zeros(1000, np.float32)))
    jax_ckpt.save(str(tmp_path / "b" / "ckpt_0.npz"), flat, meta={"epoch": 0, "completed": 1},
                  topology=ckpt.topology_record(2, [".opt_state.m", ".opt_state.v"]))
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore_latest(str(tmp_path / "b"), model, opt)
    # a comm hook's residual is ported (tests/test_torch_port_comm_ckpt.py);
    # one saved at another world size is the elastic reshard's
    raw = sum(p.numel() for p in model.parameters())
    jax_ckpt.save_on_main(str(tmp_path / "c"), 0,
                          dataclasses.replace(state, comm_state=jnp.zeros(2 * raw)), world_size=2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8: elastic reshard"):
        ckpt.restore_latest(str(tmp_path / "c"), model, opt, comm_state=torch.zeros(raw))
    # the numerical guard's counters are ported: a guarded run restores them
    # (tests/test_torch_port_guard_loop.py), an unguarded one does not read them
    jax_ckpt.save_on_main(str(tmp_path / "d"), 0, dataclasses.replace(
        state, skipped_steps={"total": jnp.int32(4), "consecutive": jnp.int32(2)}), world_size=1)
    from tpuddp_torch.resilience.guard import init_skip_counters, read_skip_counters

    counters = init_skip_counters()
    ckpt.restore_latest(str(tmp_path / "d"), model, opt, skipped=counters)
    assert read_skip_counters(counters) == (4, 2)
    ckpt.restore_latest(str(tmp_path / "d"), model, opt)


def test_a_file_of_another_model_or_moment_type_is_refused(tmp_path, cpu_devices):
    state = _jax_state("toy_mlp", "float32", cpu_devices)
    jax_ckpt.save_on_main(str(tmp_path), 0, state, world_size=1)
    model, opt = _port("toy_mlp", "bfloat16")
    with pytest.raises(ValueError, match="optimizer_state_dtype"):
        ckpt.restore_latest(str(tmp_path), model, opt)
    other = load_model("toy_mlp", 12, input_shape=(8, 8, 3))
    with pytest.raises(ValueError, match="shape"):
        ckpt.load(str(tmp_path / "ckpt_0.npz"), other)


@pytest.mark.parametrize("value,wanted", [("1", True), ("yes", True), ("0", False), ("", False)])
def test_auto_resume_env_is_read_as_the_jax_package_reads_it(monkeypatch, value, wanted):
    from tpuddp.resilience.preemption import auto_resume_requested

    monkeypatch.setenv(ckpt.AUTO_RESUME_ENV, value)
    assert ckpt.auto_resume_requested() == auto_resume_requested() == wanted


def test_jax_prng_key_is_the_jax_packages():
    """The run key of a native file is the JAX entry point's
    (tests/test_torch_port_rng_keys.py holds threefry itself)."""
    for seed in (0, 7, 2**31 + 5, 2**40 + 3):
        want = jax.random.split(jax.random.fold_in(jax.random.key(seed % 2**63), 0))[1]
        np.testing.assert_array_equal(jax_run_key(seed), jax.random.key_data(want))
