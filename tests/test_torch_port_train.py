"""The port's training slice (tpuddp_torch) against the JAX package, on the
CPU: AlexNet train-step gradients and losses, a 2-process Gloo DDP epoch,
the entry point's log lines, configuration refusals, seeding, the launcher,
checkpoints and import hygiene.

Tolerances: gradients rtol 1e-4 / atol 1e-6 and losses rtol 1e-4 — float32
convolutions and matmuls summed in another order by two libraries, over at
most 3 Adam steps."""

import ast
import json
import os
import random
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import optim as jax_optim
from tpuddp import seeding as jax_seeding
from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.data import transforms as jax_tf
from tpuddp.data.synthetic import SyntheticClassification as JaxSynthetic
from tpuddp.models import AlexNet as JaxAlexNet
from tpuddp.models import ToyMLP as JaxToyMLP
from tpuddp.models.torch_import import convert_alexnet_state_dict
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.nn.core import Context
from tpuddp.nn.loss import cross_entropy as jax_cross_entropy
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.training.loop import run_training_loop as jax_run_training_loop

from tpuddp_torch import config as cfg
from tpuddp_torch import seeding
from tpuddp_torch.data import compute_dtype_for
from tpuddp_torch.data.transforms import make_train_augment
from tpuddp_torch.models import AlexNet, ToyMLP
from tpuddp_torch.models.convert import state_dict_from_jax
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.optim import Adam
from tpuddp_torch.parallel import backend
from tpuddp_torch.parallel.ddp import DistributedDataParallel
from tpuddp_torch.parallel.spawn import run_ddp_training
from tpuddp_torch.training import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_port_worker as worker_cfg  # noqa: E402

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LOSS_RTOL = 1e-4
SPAWN_TIMEOUT_S = 180


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    env.pop("TPUDDP_WORLD_SIZE", None)
    return env


# ---------------------------------------------------------------- AlexNet --

@pytest.fixture(scope="module")
def alexnet_setup():
    """AlexNet at 64 px, batch 4 (last row padding), dropout 0, no flip: the
    two packages draw different random numbers, so the step is compared
    where it has none."""
    torch.manual_seed(0)
    model = AlexNet(num_classes=10, dropout=0.0)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    jax_model = JaxAlexNet(num_classes=10, dropout=0.0)
    # shapes only: every parameter is replaced from the state_dict
    template, mstate = jax.eval_shape(
        jax_model.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3))
    )
    params = convert_alexnet_state_dict(sd, template)
    rng = np.random.RandomState(5)
    batches = [
        (
            rng.randint(0, 256, size=(4, 32, 32, 3)).astype(np.uint8),
            rng.randint(0, 10, size=4).astype(np.int32),
            np.array([1, 1, 1, 0], np.float32),
        )
        for _ in range(3)
    ]
    return sd, jax_model, params, mstate, batches


def test_first_step_gradients_match_jax(alexnet_setup):
    sd, jax_model, params, mstate, batches = alexnet_setup
    x, y, w = batches[0]
    model = AlexNet(num_classes=10, dropout=0.0)
    model.load_state_dict(sd)
    augment = make_train_augment(size=64, flip=False)
    loss = CrossEntropyLoss()(model(augment(torch.from_numpy(x))),
                              torch.from_numpy(y), torch.from_numpy(w))
    loss.backward()

    jax_augment = jax_tf.make_train_augment(size=64, flip=False)

    def jax_loss(p):
        xa = jax_augment(None, jnp.asarray(x))
        logits, _ = jax_model.apply(p, mstate, xa, Context(train=True, rng=jax.random.key(1)))
        return jax_cross_entropy(logits, jnp.asarray(y), weights=jnp.asarray(w))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    ref = state_dict_from_jax("alexnet", _np_tree(ref_grads))
    for name, prm in model.named_parameters():
        np.testing.assert_allclose(
            prm.grad.numpy(), ref[name].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
            err_msg=name,
        )


def test_three_step_losses_match_jax_ddp(alexnet_setup, cpu_devices):
    """The port's DDP (one process) against the JAX DDP on one device:
    augment, forward, weighted loss, backward, Adam, 3 times."""
    sd, jax_model, params, mstate, batches = alexnet_setup
    jax_ddp = JaxDDP(
        jax_model, jax_optim.Adam(1e-3), JaxCrossEntropyLoss(),
        mesh=make_mesh(cpu_devices[:1]),
        augment=jax_tf.make_train_augment(size=64, flip=False),
    )
    state = jax_ddp.init_state(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), params=params, model_state=mstate
    )
    model = AlexNet(num_classes=10, dropout=0.0)
    model.load_state_dict(sd)
    ddp = DistributedDataParallel(
        model, Adam(model.parameters(), lr=1e-3), CrossEntropyLoss(),
        augment=make_train_augment(size=64, flip=False), device="cpu",
    )
    for batch in batches:
        state, metrics = jax_ddp.train_step(state, jax_ddp.shard(batch))
        ours = ddp.train_step(batch)
        np.testing.assert_allclose(
            ours.numpy(),
            [float(np.asarray(metrics["loss_sum"])[0]), float(np.asarray(metrics["n"])[0])],
            rtol=LOSS_RTOL,
        )
    assert ddp.optimizer.state[next(model.parameters())]["step"] == 3


# ------------------------------------------------------- 2-process Gloo --

def test_two_process_gloo_matches_shard_grads_and_jax_epoch_loss(tmp_path, cpu_devices):
    """Two Gloo processes through the port's launcher: the synced gradient
    is the mean of the per-shard weighted-mean gradients (rank 1's shard is
    padded), and the 2-epoch losses track the JAX DDP on a 2-device mesh."""
    shape = worker_cfg.SHAPE
    jax_model = JaxToyMLP(num_classes=10, hidden=worker_cfg.HIDDEN)
    params, mstate = jax_model.init(jax.random.key(7), jnp.zeros((1, *shape)))
    sd = state_dict_from_jax("toy_mlp", _np_tree(params))
    np.savez(tmp_path / "init.npz", **{k: v.numpy() for k, v in sd.items()})
    rng = np.random.RandomState(9)
    shards = []
    for r, n_real in enumerate((6, 4)):
        x = rng.randn(6, *shape).astype(np.float32)
        y = rng.randint(0, 10, 6).astype(np.int64)
        w = (np.arange(6) < n_real).astype(np.float32)
        shards.append((x, y, w))
    np.savez(tmp_path / "grad_batches.npz", **{
        f"{k}{r}": a for r, s in enumerate(shards) for k, a in zip("xyw", s)
    })

    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_worker.py"), str(tmp_path)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Train loss on replica 1:" in proc.stdout

    shard_grads = []
    for x, y, w in shards:
        model = ToyMLP(int(np.prod(shape)), 10, worker_cfg.HIDDEN)
        model.load_state_dict(sd)
        CrossEntropyLoss()(model(torch.from_numpy(x)), torch.from_numpy(y),
                           torch.from_numpy(w)).backward()
        shard_grads.append({k: p.grad.numpy() for k, p in model.named_parameters()})
    g0, g1 = (np.load(tmp_path / f"grads_{r}.npz") for r in range(2))
    for k in g0.files:
        np.testing.assert_array_equal(g0[k], g1[k])  # every replica agrees
        np.testing.assert_allclose(
            g0[k], (shard_grads[0][k] + shard_grads[1][k]) / 2, rtol=1e-5, atol=1e-7
        )

    train, test = JaxSynthetic(
        n=worker_cfg.DATA_N, shape=shape, seed=worker_cfg.DATA_SEED
    ).split(worker_cfg.DATA_TEST)
    mesh = make_mesh(cpu_devices[:2])
    jax_ddp = JaxDDP(jax_model, jax_optim.Adam(worker_cfg.LR), JaxCrossEntropyLoss(), mesh=mesh)
    state = jax_ddp.init_state(
        jax.random.key(0), jnp.zeros((1, *shape)), params=params, model_state=mstate
    )
    _, ref_history = jax_run_training_loop(
        jax_ddp, state,
        JaxLoader(train, worker_cfg.BATCH, mesh, shuffle=True),
        JaxLoader(test, worker_cfg.BATCH, mesh, shuffle=True),
        save_dir=None, num_epochs=worker_cfg.EPOCHS, log=lambda *_: None,
    )
    with open(tmp_path / "history.json") as f:
        history = json.load(f)
    assert len(history) == len(ref_history) == worker_cfg.EPOCHS
    for ours, ref in zip(history, ref_history):
        assert ours["train_samples"] == ref["train_samples"] == worker_cfg.DATA_N - worker_cfg.DATA_TEST
        for key in ("train_loss", "test_loss"):
            np.testing.assert_allclose(ours[key], ref[key], rtol=LOSS_RTOL)


# ------------------------------------------------------------ entry point --

def test_entry_point_prints_the_reference_log_lines(tmp_path):
    out = tmp_path / "out"
    settings = tmp_path / "s.yaml"
    settings.write_text(
        f"out_dir: {out}\n"
        "local: {device: cpu}\n"
        "training: {model: toy_mlp, data_root: /nonexistent, synthetic_n: [64, 32],\n"
        "           train_batch_size: 16, test_batch_size: 16, num_epochs: 1,\n"
        "           image_size: null, seed: 0}\n"
    )
    proc = subprocess.run(
        [sys.executable, "-m", "tpuddp_torch.train_native", "--settings_file", str(settings)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env(), cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    for expected in (
        "Process 0, Epoch 0",
        "DistributedSampler.set_epoch: True",
        "Training on 4 batches, test on 2 batches",
        "Finished Training on process 0.",
    ):
        assert expected in lines, expected
    assert any(re.fullmatch(r"Train loss on replica 0: \d+\.\d{4} based on 64 samples", l) for l in lines)
    assert any(re.fullmatch(r"Test loss on replica 0: \d+\.\d{4} based on 32 samples", l) for l in lines)
    assert any(re.fullmatch(
        r"Epoch 1/1, Train Loss: \d+\.\d{4}, Test Loss: \d+\.\d{4}, Test Accuracy: \d+\.\d{2}%", l
    ) for l in lines)
    assert "torch.backends.cuda.matmul.allow_tf32=False, torch.backends.cudnn.allow_tf32=False" in lines
    assert ckpt.verify_file(str(out / "ckpt_0.npz")) and (out / "s.yaml").exists()


# ---------------------------------------------------------------- config --

@pytest.mark.parametrize("knob,value", [
    ("mode", "auto"),
    ("reshard_on_mismatch", True),
])
def test_unported_knobs_are_refused(knob, value):
    """Neither knob is refused any more: ``mode: auto`` runs the global
    batch's step (tests/test_torch_port_auto.py), and
    ``reshard_on_mismatch`` at model 1 on both sides changes nothing, as in
    the JAX package (a file of another model width is reshaped on load:
    tests/test_torch_port_tp_elastic.py)."""
    assert cfg.training_config({"training": {knob: value}})[knob] == value


@pytest.mark.parametrize("env,parallel,refused", [
    ("1", None, False), ("2", None, True), (None, {"model": 2}, True), ("1", {"model": 2}, False),
])
def test_model_size_over_1_is_refused(monkeypatch, env, parallel, refused):
    """``$TPUDDP_MODEL_SIZE`` (the supervisor's lever) overrides
    ``parallel.model`` as ``tpuddp/config.py:335-363`` does. A width over 1
    is tensor parallel, which is ported: accepted on a world it tiles, and
    on one it does not the JAX package's ValueError (``refused`` names the
    cases whose width is 2)."""
    monkeypatch.delenv("TPUDDP_MODEL_SIZE", raising=False)
    if env is not None:
        monkeypatch.setenv("TPUDDP_MODEL_SIZE", env)
    settings = {} if parallel is None else {"parallel": parallel}
    cfg.check_settings(settings)
    assert cfg.check_settings(settings, world_size=4)["model"] == (2 if refused else 1)
    if refused:
        with pytest.raises(ValueError, match="does not tile the 3-device world"):
            cfg.check_settings(settings, world_size=3)
    else:
        cfg.check_settings(settings, world_size=3)


@pytest.mark.parametrize("knob,value", [
    ("snapshot", True),
    ("pipeline", {"device_augment": False}),
])
def test_the_drain_slices_knobs_are_accepted(knob, value):
    """``training.snapshot`` and ``pipeline.device_augment: false`` are
    ported (tests/test_torch_port_snapshot.py, tests/test_torch_port_preempt.py)."""
    assert cfg.training_config({"training": {knob: value}})[knob] == value


@pytest.mark.parametrize("knob,value,message", [
    ("comm_hook", "fp8", "unknown comm_hook 'fp8'"),
    ("bucket_cap_mb", 0, "bucket_cap_mb must be > 0, got 0"),
    ("topk_density", 0, r"topk density must be in \(0, 1\], got 0"),
    ("topk_density", 1.5, r"topk density must be in \(0, 1\], got 1.5"),
])
def test_malformed_comm_hook_knobs_are_the_jax_packages_value_errors(knob, value, message):
    """The comm hooks are ported: a bad value is the JAX package's
    ValueError (``tpuddp/parallel/comm.py:138-175, :213-214``)."""
    with pytest.raises(ValueError, match=message):
        cfg.training_config({"training": {knob: value}})


def test_weight_update_sharding_is_accepted():
    assert cfg.training_config({"training": {"weight_update_sharding": True}})[
        "weight_update_sharding"] is True


@pytest.mark.parametrize("settings,message", [
    ({"training": {"mode": "auto"}}, "requires mode='shard_map'"),
    ({"training": {"comm_topology": "hierarchical"}}, "mutually exclusive"),
    ({"parallel": {"model": 2}}, "parallel.model > 1 with weight_update_sharding"),
])
def test_weight_update_sharding_combinations_the_jax_package_refuses(settings, message):
    """ZeRO-1 with mode auto, the hierarchical topology or a model axis:
    the JAX package's ValueError (tpuddp/parallel/ddp.py:195-300), before
    the refusal of the knob that is not ported yet."""
    settings = {**settings, "training": {**settings.get("training", {}),
                                         "weight_update_sharding": True}}
    with pytest.raises(ValueError, match=message):
        cfg.check_settings(settings, world_size=2)
        cfg.training_config(settings)


@pytest.mark.parametrize("knob,value", [
    ("optimizer", "sgd"), ("optimizer", "lars"), ("clip_grad_norm", 1.0),
])
def test_optimizer_knobs_are_accepted(knob, value):
    assert cfg.training_config({"training": {knob: value}})[knob] == value


@pytest.mark.parametrize("knob,value", [("deferred_metrics", True), ("fuse_steps", 4)])
def test_fused_step_knobs_are_accepted(knob, value):
    assert cfg.training_config({"training": {knob: value}})[knob] == value


@pytest.mark.parametrize("knob,value", [
    ("resume", True), ("auto_resume", True), ("keep_last", 2),
    ("pipeline", {"depth": 3, "sync_readback": True}), ("pipeline", False),
])
def test_resume_and_pipeline_knobs_are_accepted(knob, value):
    assert cfg.training_config({"training": {knob: value}})[knob] == value


@pytest.mark.parametrize("knob,value", [
    ("pipeline", {"depht": 2}), ("pipeline", {"depth": 0}), ("pipeline", 3),
])
def test_malformed_resume_and_pipeline_knobs_raise(knob, value):
    with pytest.raises(ValueError, match=f"{knob}"):
        cfg.training_config({"training": {knob: value}})


def test_ported_knobs_are_accepted_and_reach_the_optimizer():
    """sync_bn, compute_dtype and optimizer_state_dtype: bf16 moments end
    up in the Adam that optimizer_from builds."""
    training = cfg.training_config({"training": {
        "sync_bn": True, "compute_dtype": "bfloat16", "optimizer_state_dtype": "bfloat16",
    }})
    opt = cfg.optimizer_from(training, [torch.nn.Parameter(torch.zeros(2))], leaf_index=[0])
    assert opt.state_dtype == torch.bfloat16
    for name in ("bf16", "float32", None):
        training = cfg.training_config({"training": {"optimizer_state_dtype": name}})
        cfg.optimizer_from(training, [torch.nn.Parameter(torch.zeros(2))], leaf_index=[0])


@pytest.mark.parametrize("knob,value", [
    ("compute_dtype", "float16"), ("compute_dtype", "fp8"),
    ("optimizer_state_dtype", "float16"), ("optimizer_state_dtype", "int8"),
])
def test_unknown_dtypes_raise(knob, value):
    training = cfg.training_config({"training": {knob: value}})
    with pytest.raises(ValueError, match=f"training.{knob}"):
        if knob == "compute_dtype":
            compute_dtype_for(training)
        else:
            cfg.optimizer_from(training, [torch.nn.Parameter(torch.zeros(2))])


def test_bf16_state_is_an_adam_knob():
    """tpuddp/config.py:768-772: optimizer_state_dtype with another
    optimizer is a ValueError; without it the optimizer is built."""
    with pytest.raises(ValueError, match="Adam knob"):
        cfg.optimizer_from({"optimizer": "sgd", "optimizer_state_dtype": "bfloat16",
                            "learning_rate": 0.1}, [])
    sgd = cfg.optimizer_from({"optimizer": "sgd", "learning_rate": 0.1},
                             [torch.nn.Parameter(torch.zeros(2))])
    assert type(sgd).__name__ == "SGD" and sgd.defaults["momentum"] == 0.9


@pytest.mark.parametrize("settings", [
    {"parallel": {"model": 2}},
    {"observability": {"exporter": True, "advisor": True}},
])
def test_unported_settings_blocks_are_refused(settings):
    """The advisor is not ported (NotImplementedError naming its ROADMAP
    item). A ``parallel`` block is: ``model: 2`` is accepted on a world it
    tiles, with the JAX package's ValueErrors where it does not, under
    ``hierarchical``, and (at the wrap) for a model without partition
    metadata (tests/test_torch_port_mesh2d.py)."""
    if "parallel" not in settings:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cfg.check_settings(settings)
        return
    cfg.check_settings(settings, world_size=4)
    with pytest.raises(ValueError, match="does not tile"):
        cfg.check_settings(settings, world_size=3)
    with pytest.raises(ValueError, match="hierarchical"):
        cfg.check_settings({**settings, "training": {"comm_topology": "hierarchical"}}, 4)


def test_parallel_data_must_tile_the_world():
    cfg.check_settings({"parallel": {"data": 2, "model": 1}}, world_size=2)
    cfg.check_settings({"parallel": {"data": "auto"}}, world_size=3)
    with pytest.raises(ValueError, match="tile the world"):
        cfg.check_settings({"parallel": {"data": 2}}, world_size=4)


def test_defaults_and_identity_knobs_are_accepted():
    training = cfg.training_config({"training": {
        "scan_steps": 16, "prefetch": False, "comm_overlap": False, "weight_decay": 0.1,
        "optimizer_state_dtype": "float32",
    }})
    assert training["model"] == "alexnet" and training["image_size"] == 224
    opt = cfg.optimizer_from(training, [torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(opt, Adam) and opt.defaults["weight_decay"] == 0.1
    with pytest.raises(ValueError, match="did you mean 'weight_decay'"):
        cfg.training_config({"training": {"wieght_decay": 0.1}})


def test_world_size_and_device_sources(monkeypatch):
    monkeypatch.delenv("TPUDDP_WORLD_SIZE", raising=False)
    assert cfg.world_size_from({}) is None
    assert cfg.world_size_from({"local": {"condor": {"num_gpus": 3}}}) == 3
    assert cfg.world_size_from({"local": {"gpu": {"num_gpus": 2}, "condor": {"num_gpus": 3}}}) == 2
    monkeypatch.setenv("TPUDDP_WORLD_SIZE", "4")
    assert cfg.world_size_from({"local": {"gpu": {"num_gpus": 2}}}) == 4
    assert cfg.device_from({}) == "cuda"
    assert cfg.device_from({"local": {"device": "cpu"}}) == "cpu"
    with pytest.raises(ValueError):
        cfg.device_from({"local": {"device": "tpu"}})


# --------------------------------------------------------------- seeding --

def test_seeding_keeps_the_reference_quirk_and_matches_jax():
    """Python/NumPy get (base % (2**32-1)) + rank, as in the JAX package;
    torch gets base + rank."""
    base, rank = 2**40 + 12345, 2
    jax_seeding.set_seed_based_on_rank(rank, base)
    ref = (random.random(), np.random.rand())
    gen, got_base = seeding.set_seed_based_on_rank(rank, base)
    assert got_base == base
    assert (random.random(), np.random.rand()) == ref
    assert torch.initial_seed() == base + rank
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=torch.Generator().manual_seed(base + rank)))
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    assert f"base seed: {base}" in seeding.rng_probe_string(base)


# ------------------------------------------------ backend, spawn, ddp ----

def test_backend_ladder_and_missing_gpu(monkeypatch):
    assert backend.detect_backend("cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(backend.BackendUnavailableError, match="no GPU"):
        backend.detect_backend("cuda")
    with pytest.raises(backend.BackendUnavailableError):
        run_ddp_training(lambda *a: None, 1, "/tmp", {}, backend="cuda")
    with pytest.raises(ValueError):
        backend.detect_backend("tpu")


def test_ddp_defaults_to_cuda_and_raises_without_a_gpu(monkeypatch):
    """A wrap that names no device is on ``cuda``; with no GPU it raises
    instead of moving the model to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = ToyMLP(12, 10, (4,))
    with pytest.raises(backend.BackendUnavailableError, match="no GPU"):
        DistributedDataParallel(model, Adam(model.parameters()), CrossEntropyLoss())
    ddp = DistributedDataParallel(
        model, Adam(model.parameters()), CrossEntropyLoss(), device="cpu"
    )
    assert ddp.device == torch.device("cpu")
    assert next(ddp.model.parameters()).device == torch.device("cpu")


def test_spawn_world_one_runs_in_process_and_propagates(tmp_path):
    torch.set_num_threads(2)
    seen = []

    def demo(rank, world_size, save_dir, optional_args):
        seen.append((rank, world_size, backend.get_world_size(), save_dir))
        return "done"

    assert run_ddp_training(demo, 1, str(tmp_path), {}, backend="cpu") == "done"
    assert seen == [(0, 1, 1, str(tmp_path))]

    def boom(*args):
        raise KeyError("worker failure")

    with pytest.raises(KeyError, match="worker failure"):
        run_ddp_training(boom, 1, str(tmp_path), {}, backend="cpu")
    assert not torch.distributed.is_initialized()  # cleaned up on the way out


def test_rendezvous_port_is_bound_from_the_moment_it_is_picked():
    """The launcher's store takes its port from the OS as it binds, on every
    address: nothing else can bind the port between its pick and the ranks'
    rendezvous (a port picked on 127.0.0.1 and released could be taken on
    another address, where the store also listens)."""
    import errno
    import socket

    store = backend.rendezvous_store(2)
    for host in ("", "127.0.0.1"):
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            with pytest.raises(OSError) as err:
                s.bind((host, store.port))
            assert err.value.errno == errno.EADDRINUSE
    with pytest.raises(ValueError, match="rendezvous port"):
        backend.setup(0, 2, "cpu")


def test_many_groups_in_turn_keep_the_excepthook(tmp_path):
    """One process runs world-1 groups one after another (as a smoke run
    does): each gets a port of its own, and cleanup hands back the excepthook
    that init_process_group wraps, so a later traceback is not prefixed once
    per group that came before."""
    import sys

    hook = sys.excepthook
    worlds = []
    for _ in range(25):
        run_ddp_training(lambda *a: worlds.append(backend.get_world_size()),
                         1, str(tmp_path), {}, backend="cpu")
        assert sys.excepthook is hook
    assert worlds == [1] * 25 and not torch.distributed.is_initialized()


def test_checkpoint_round_trip_and_corruption(tmp_path):
    torch.manual_seed(0)
    model = ToyMLP(12, 3, hidden=(5,))
    opt = Adam(model.parameters(), lr=1e-2)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    path = ckpt.save_on_main(str(tmp_path), 4, model, opt, rank=0, step=1)
    assert path.endswith("ckpt_4.npz") and ckpt.verify_file(path)

    other = ToyMLP(12, 3, hidden=(5,))
    other_opt = Adam(other.parameters(), lr=1e-2)
    assert ckpt.load(path, other, other_opt) == {"epoch": 4, "completed": 1, "step": 1}
    for (k, a), b in zip(model.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), k
    for p, q in zip(model.parameters(), other.parameters()):
        assert other_opt.state[q]["step"] == 1
        assert torch.equal(opt.state[p]["exp_avg_sq"], other_opt.state[q]["exp_avg_sq"])

    with open(path, "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02")
    assert not ckpt.verify_file(path)
    with pytest.raises(ValueError, match="sha256"):
        ckpt.load(path, other)


# -------------------------------------------------------------- hygiene --

def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_tpuddp():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "tpuddp_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = {
        os.path.relpath(f, ROOT): root
        for f in files for root in _imported_roots(f)
        if root in ("jax", "jaxlib", "tpuddp")
    }
    assert not bad, bad
