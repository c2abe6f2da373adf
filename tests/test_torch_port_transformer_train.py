"""Training the transformer in the port against the JAX package, on the CPU.

``transformer_tiny`` (d 64, 4 heads, 2 layers, the registry's 128
positions) as a next-token LM at V 64, T 32, global batch 8 (as
tests/test_mesh2d.py:53-71), from the JAX package's own init carried over
by the converter, on the token stream of ``tools/bench_mesh.py``'s
``TokenLMLoader`` (the JAX side) and its port
(``tpuddp_torch/data/tokens.py``):

- 3 Adam steps through the port's DDP wrap against the JAX wrap's on one
  device: each step's loss sum and count, the final parameters;
- the port's entry-point build (``train_native.build_training`` with the
  token loaders: no augment, no eval transform) and epoch loop against the
  JAX wrap and ``run_training_loop``, one epoch of 3 steps: the epoch
  losses, every token counted (``n == B*T``), the final parameters, the
  ``run_meta`` mesh block, ``mfu_p50`` not null (the card's peak stood in
  for), and the epoch's npz against the JAX loop's (the keys equal;
  each file restored by the other package);
- ``scan_steps``: a 3-step chunk bitwise the 3 eager steps, eval groups
  bitwise the per-batch eval;
- bf16 Adam moments salted by the JAX leaf index;
- the launch tables (28 leaves: one; ``transformer_small``'s 52: 48 + 4);
- ``comm_overlap`` on a dict-tree model: the JAX wrap's reason and its
  ``ValueError``; a checkpoint of a model axis refused; bf16 compute of a
  token model refused.

Tolerances: losses and parameters rtol 1e-4 / atol 1e-5 (PERF.md section
2), or, for a parameter that the JAX package's own run moves by more than
that from an init one ulp higher, within 4 times that move (the rule of
tests/test_torch_port_comm_gloo.py). That is the key projection's bias: its
gradient is 0 in exact arithmetic (it adds one constant to a query's
scores, which the softmax cancels), so each package's is float32 rounding
noise, which Adam's first steps turn into lr-sized moves of either sign.
Everything else bitwise.
"""

import json
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import optim as jax_optim
from tpuddp.models import load_model as jax_load_model
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.training import checkpoint as jax_ckpt
from tpuddp.training.loop import run_training_loop as jax_run_training_loop

from tpuddp_torch import config as cfg
from tpuddp_torch import train_native
from tpuddp_torch.data.tokens import TokenLMLoader, token_loaders
from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import jax_leaf_index, state_dict_from_jax, torch_layout
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.observability import telemetry
from tpuddp_torch.ops import fused_adam
from tpuddp_torch.optim import Adam
from tpuddp_torch.parallel.ddp import DistributedDataParallel
from tpuddp_torch.training import checkpoint as ckpt
from tpuddp_torch.training.loop import run_training_loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from bench_mesh import TokenLMLoader as JaxTokenLMLoader  # noqa: E402

NAME, V, T, B, STEPS, TEST_BATCHES = "transformer_tiny", 64, 32, 8, 3, 2
RTOL, ATOL, LR = 1e-4, 1e-5, 1e-3
TRAINING = dict(cfg.TRAINING_DEFAULTS, model=NAME, num_classes=V, learning_rate=LR, seed=0,
                num_epochs=1, checkpoint_epoch=1, scan_steps=1, dataset="synthetic_tokens")
LOADERS = partial(token_loaders, vocab=V, seq_len=T, global_batch=B, n_batches=STEPS,
                  test_batches=TEST_BATCHES)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_model():
    return jax_load_model(NAME, num_classes=V)


@pytest.fixture(scope="module")
def init():
    params, mstate = _jax_model().init(jax.random.key(3), jnp.zeros((1, T), jnp.int32))
    assert mstate == ()
    return _np(params)


def _jax_ddp(cpu_devices, **kwargs):
    return JaxDDP(_jax_model(), jax_optim.Adam(LR), JaxCrossEntropyLoss(),
                  mesh=make_mesh(cpu_devices[:1]), **kwargs)


def _port_model(init):
    model = load_model(NAME, V)
    model.load_state_dict(state_dict_from_jax(NAME, init))
    return model


def _batches():
    return list(TokenLMLoader(V, T, B, STEPS, seed=0))


SPREAD = 4.0


def _assert_params_equal(model, jax_params):
    want = state_dict_from_jax(NAME, _np(jax_params))
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), want[n]), n


def _assert_params_close(model, jax_run):
    """Each parameter within rtol/atol of the JAX run's, or, where the JAX
    package's own run from an init one ulp higher moves it by more than
    that, within SPREAD times that move."""
    want = state_dict_from_jax(NAME, jax_run["params"])
    up = state_dict_from_jax(NAME, jax_run["params_up"])
    for n, p in model.named_parameters():
        got, ref = p.detach().double().numpy(), want[n].double().numpy()
        spread, err = np.abs(up[n].double().numpy() - ref), np.abs(got - ref)
        if np.all(err <= ATOL + RTOL * np.abs(ref)):
            continue
        assert np.any(spread > ATOL + RTOL * np.abs(ref)), (n, float(err.max()))
        assert err.max() <= SPREAD * spread.max(), (n, float(err.max()), float(spread.max()))


@pytest.fixture(scope="module")
def jax_run(cpu_devices, init):
    """3 steps of the JAX wrap from ``init`` (each step's loss sum and
    count, the final parameters) and the final parameters from an init one
    ulp higher."""
    out = {}
    for tag, params in (("", init), ("_up", jax.tree_util.tree_map(
            lambda p: np.nextafter(p, np.inf).astype(p.dtype), init))):
        ddp_j = _jax_ddp(cpu_devices)
        state = ddp_j.init_state(jax.random.key(0), jnp.zeros((1, T), jnp.int32), params=params,
                                 model_state=())
        sums = []
        for b in _batches():
            state, metrics = ddp_j.train_step(state, ddp_j.shard(b))
            sums.append([float(np.asarray(metrics[k]).sum()) for k in ("loss_sum", "n")])
        out["sums" + tag], out["params" + tag] = np.asarray(sums), _np(state.params)
    return out


# ------------------------------------------------------------ the wraps --

def test_three_adam_steps_match_the_jax_wrap(init, jax_run):
    torch.set_num_threads(2)
    model = _port_model(init)
    ddp = DistributedDataParallel(model, Adam(model.parameters(), lr=LR), CrossEntropyLoss(),
                                  device="cpu")
    got = np.stack([ddp.train_step(b).numpy() for b in _batches()])
    assert got[:, 1].tolist() == [B * T] * STEPS
    np.testing.assert_allclose(got, jax_run["sums"], rtol=RTOL)
    _assert_params_close(model, jax_run)


def test_a_chunk_is_bitwise_its_eager_steps_and_eval_counts_tokens(init):
    """``scan_steps``: one 3-step chunk against 3 per-batch steps from one
    state (parameters, moments, sums bitwise); an eval group against the
    per-batch eval, each batch's ``n`` = B*T tokens."""
    torch.set_num_threads(2)
    batches = _batches()
    runs = []
    for chunked in (False, True):
        model = _port_model(init)
        ddp = DistributedDataParallel(model, Adam(model.parameters(), lr=LR), CrossEntropyLoss(),
                                      device="cpu")
        sums = (ddp.train_step_many(batches) if chunked
                else sum(ddp.train_step(b) for b in batches))
        ev = (ddp.eval_step_many(batches) if chunked else [ddp.eval_step(b) for b in batches])
        runs.append((sums, ev, {n: p.detach().clone() for n, p in model.named_parameters()},
                     [t.clone() for st in ddp.optimizer.state.values() for t in
                      (st["exp_avg"], st["exp_avg_sq"])], ddp.step))
    (s0, e0, p0, m0, k0), (s1, e1, p1, m1, k1) = runs
    assert torch.equal(s0, s1) and k0 == k1 == STEPS
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    assert all(torch.equal(a, b) for a, b in zip(m0, m1))
    assert [float(e[2]) for e in e0] == [B * T] * STEPS
    assert torch.equal(sum(e0), e1)


# ------------------------------------------------------------- the loops --

@pytest.fixture(scope="module")
def loops(tmp_path_factory, cpu_devices, init):
    """One epoch of 3 steps through each package's loop from one init,
    each writing its epoch's npz; the port's with the card's peak standing
    in for the CPU's unknown one, so its MFU fields are numbers."""
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("token_loops")
    ddp_j = _jax_ddp(cpu_devices)
    state = ddp_j.init_state(jax.random.key(0), jnp.zeros((1, T), jnp.int32), params=init, model_state=())
    state, jax_history = jax_run_training_loop(
        ddp_j, state, JaxTokenLMLoader(V, T, B, STEPS, seed=0),
        JaxTokenLMLoader(V, T, B, TEST_BATCHES, seed=1), str(root / "jax"), num_epochs=1,
        checkpoint_epoch=1, scan_steps=1, log=lambda *a, **k: None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(telemetry, "device_peak_flops", lambda kind: 989e12)
        ddp, train, test, seed = train_native.build_training(0, 1, dict(TRAINING), "cpu", LOADERS)
        ddp.model.load_state_dict(state_dict_from_jax(NAME, init))
        history = run_training_loop(
            ddp, train, test, str(root / "port"), num_epochs=1, checkpoint_epoch=1,
            base_seed=seed, scan_steps=1, model_input=train_native.model_input_for(TRAINING, train),
            log=lambda *a, **k: None)
    yield dict(root=root, jax_state=state, jax_history=jax_history, ddp=ddp, history=history)


def test_the_entry_build_takes_no_augment_and_int_tokens(loops):
    ddp = loops["ddp"]
    assert ddp.augment is None and ddp.eval_transform is None
    assert train_native.model_input_for(TRAINING, LOADERS(0, 1)[0]) == ((B, T), torch.int32)
    assert ddp.comm_overlap_meta["enabled"] is False


def test_the_loop_matches_the_jax_loop(loops, jax_run):
    """The JAX loop's steps are its wrap's (its parameters bitwise those of
    ``jax_run``), so the wrap's spread holds the port loop's parameters."""
    (got,), (want,) = loops["history"], loops["jax_history"]
    for k in ("train_loss", "test_loss", "test_accuracy"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert got["train_samples"] == want["train_samples"] == STEPS * B * T
    assert got["test_samples"] == want["test_samples"] == TEST_BATCHES * B * T
    jax.tree_util.tree_map(np.testing.assert_array_equal, _np(loops["jax_state"].params),
                           jax_run["params"])
    _assert_params_close(loops["ddp"].model, jax_run)


def test_the_epoch_row_has_an_mfu_and_the_header_the_jax_mesh_block(loops):
    row = loops["history"][0]
    assert row["mfu_p50"] is not None and row["mfu_p50"] > 0
    headers = []
    for side in ("port", "jax"):
        with open(loops["root"] / side / "history.jsonl") as f:
            headers.append(json.loads(f.readline()))
    assert headers[0]["mesh"] == headers[1]["mesh"] == {"data": 1, "model": 1, "tp_rules_hash": None}


def test_the_epoch_files_cross_both_ways(loops, cpu_devices, init, tmp_path):
    root, ddp = loops["root"], loops["ddp"]
    files = [np.load(root / side / "ckpt_0.npz") for side in ("port", "jax")]
    assert set(files[0].files) - {ckpt.RNG_KEY} == set(files[1].files)  # + the port's own streams
    assert ".params['blocks'][1]['mlp']['w2']" in files[0].files
    assert ".opt_state.v['pos']['weight']" in files[0].files
    # the JAX file into the port: the JAX loop's state exactly
    model = load_model(NAME, V)
    opt = Adam(model.parameters(), lr=LR)
    assert ckpt.restore_latest(str(root / "jax"), model, opt)[0] == 1
    jax_state = loops["jax_state"]
    _assert_params_equal(model, jax_state.params)
    m = torch_layout(NAME, _np(jax_state.opt_state.m))
    for n, p in model.named_parameters():
        assert opt.state[p]["step"] == STEPS
        np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(), m[n])
    # the port's file into the JAX package: the port's state exactly
    template = _jax_ddp(cpu_devices).init_state(jax.random.key(1), jnp.zeros((1, T), jnp.int32),
                                                params=init, model_state=())
    restored, epoch = jax_ckpt.restore_latest(str(root / "port"), template, world_size=1)
    assert epoch == 1 and int(restored.step) == STEPS
    for n, t in state_dict_from_jax(NAME, _np(restored.params)).items():
        assert torch.equal(t, ddp.model.state_dict()[n]), n


def test_a_model_axis_file_is_refused(loops, tmp_path):
    """A token file whose topology record says model=2 (a tensor-parallel
    run's) is refused whole."""
    with np.load(loops["root"] / "port" / "ckpt_0.npz") as data:
        stored = dict(data.items())
    key = next(k for k in stored if "topology" in k)
    topo = json.loads(str(stored[key]))
    topo.update(model_size=2, mesh_axes=["data", "model"], mesh_shape=[1, 2])
    stored[key] = np.asarray(json.dumps(topo))
    np.savez(tmp_path / "ckpt_0.npz", **stored)
    model = load_model(NAME, V)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8: tensor parallel"):
        ckpt.restore_latest(str(tmp_path), model, Adam(model.parameters(), lr=LR))


# ------------------------------------------------------------ bf16 moments --

def _bf16_neighbours(x32):
    bits = x32.view(np.uint32)
    down = (bits & np.uint32(0xFFFF0000)).view(np.float32)
    up = ((bits & np.uint32(0xFFFF0000)) + np.uint32(0x10000)).view(np.float32)
    return down, np.where((bits & np.uint32(0xFFFF)) == 0, down, up)


def test_bf16_moments_are_salted_by_the_jax_leaf_index(init):
    """Adam with bf16 moments from the same gradients, 3 steps: every leaf
    whose element order is the JAX one (vectors, the embedding tables)
    rounds bitwise as the JAX package's at every step, so its salt is its
    JAX leaf index; a projection's weight (transposed) takes its noise in
    the port's order, and after the first step each of its moments is a
    bf16 neighbour of the JAX float32 one."""
    rng = np.random.default_rng(5)
    grads = [jax.tree_util.tree_map(lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(
        np.float32), init) for _ in range(3)]
    opt = jax_optim.Adam(LR, state_dtype="bfloat16")
    model = _port_model(init)
    leaf = jax_leaf_index(NAME, model)
    ours = Adam(model.parameters(), lr=LR, state_dtype="bf16",
                leaf_index=[leaf[n] for n, _ in model.named_parameters()])
    p, state = init, opt.init(init)
    update = jax.jit(opt.update)
    for step, g in enumerate(grads, start=1):
        p, state = update(g, state, p)
        port_g = torch_layout(NAME, g)
        for n, t in model.named_parameters():
            t.grad = torch.from_numpy(port_g[n].copy())
        ours.step()
        want = {k: torch_layout(NAME, jax.tree_util.tree_map(
            lambda a: np.asarray(a).view(np.uint16), _np(tree)))
            for k, tree in (("exp_avg", state.m), ("exp_avg_sq", state.v))}
        bitwise = 0
        for n, t in model.named_parameters():
            for key in ("exp_avg", "exp_avg_sq"):
                got = ours.state[t][key].view(torch.int16).numpy().view(np.uint16)
                if t.dim() == 1 or n in ("embed.weight", "pos.weight"):
                    np.testing.assert_array_equal(got, want[key][n], err_msg=f"{n} {key} {step}")
                    bitwise += 1
        assert bitwise == 2 * (8 * 2 + 2 + 2)  # 8 vectors a block, ln_f's 2, 2 tables
        if step == 1:  # from zero moments: the JAX float32 m and v of one step
            g0 = torch_layout(NAME, grads[0])
            f32 = {"exp_avg": {n: (1 - opt.b1) * g for n, g in g0.items()},
                   "exp_avg_sq": {n: (1 - opt.b2) * g * g for n, g in g0.items()}}
            for n, t in model.named_parameters():
                for key in ("exp_avg", "exp_avg_sq"):
                    down, up = _bf16_neighbours(np.ascontiguousarray(f32[key][n], np.float32))
                    g32 = ours.state[t][key].float().numpy()
                    assert ((g32 == down) | (g32 == up)).all(), f"{n} {key}"


def test_the_launch_tables_of_the_transformers():
    """28 leaves (transformer_tiny) take one launch table; 52
    (transformer_small: 12 a block x 4, embed, pos and ln_f's 2) take two,
    48 + 4."""
    for name, want in (("transformer_tiny", [28]), ("transformer_small", [48, 4])):
        with torch.device("meta"):
            numels = [p.numel() for p in load_model(name, 256).parameters()]
        ptrs = [(16 * i,) * 4 for i in range(1, len(numels) + 1)]
        bcs = [fused_adam.bias_corrections(1, (0.9, 0.999))] * len(numels)
        tables = fused_adam.launch_tables(ptrs, numels, [b[0] for b in bcs], [b[1] for b in bcs])
        assert [len(t) for t in tables] == want


# ------------------------------------------------------------- refusals --

def test_comm_overlap_on_a_token_model_is_the_jax_wraps(cpu_devices, init):
    """The JAX wrap's overlap resolution on a tree that is not a
    ``Sequential`` (``tpuddp/parallel/ddp.py:662-666``): ``auto`` keeps the
    barrier step with its reason, ``true`` is its ``ValueError``."""
    ddp_j = _jax_ddp(cpu_devices, comm_hook="bf16_ef")
    ddp_j.init_state(jax.random.key(0), jnp.zeros((1, T), jnp.int32), params=init, model_state=())
    model = _port_model(init)
    ddp = DistributedDataParallel(model, Adam(model.parameters(), lr=LR), CrossEntropyLoss(),
                                  device="cpu", comm_hook="bf16_ef")
    assert ddp.comm_overlap_meta == ddp_j.comm_overlap_meta
    assert "TransformerLM has no child decomposition" in ddp.comm_overlap_meta["reason"]
    errors = []
    with pytest.raises(ValueError) as port_err:
        DistributedDataParallel(model, Adam(model.parameters(), lr=LR), CrossEntropyLoss(),
                                device="cpu", comm_overlap=True)
    errors.append(str(port_err.value))
    with pytest.raises(ValueError) as jax_err:
        _jax_ddp(cpu_devices, comm_overlap=True).init_state(
            jax.random.key(0), jnp.zeros((1, T), jnp.int32), params=init, model_state=())
    errors.append(str(jax_err.value))
    assert errors[0] == errors[1]


def test_bf16_compute_of_a_token_model_is_refused():
    with pytest.raises(NotImplementedError, match="Queue 1 item 8: bf16 compute of token models"):
        cfg.training_config({"training": {"model": NAME, "compute_dtype": "bfloat16"}})
    assert cfg.training_config({"training": {"model": NAME}})["compute_dtype"] == "float32"
