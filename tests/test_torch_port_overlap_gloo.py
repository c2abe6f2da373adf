"""The segmented-overlap step (``comm_overlap``) across two Gloo processes:
configs/digits_tpu.yaml's block (toy_cnn with sync_bn on the 1,437 digit
scans at 8 px, batch 32, buckets of 2 KB: four segments), each run with
``comm_overlap: true`` and ``false`` in one launch of
``tests/_torch_port_zero1_worker.py``:

- per step (``none``, ``bf16`` and ``topk_ef`` at ``scan_steps: 1``), per
  cycle (``none`` at A = 2) and per chunk (``int8_ef`` at ``scan_steps:
  4``, ``bf16_ef`` at A = 2 in chunks of 4): the segmented run bitwise the
  barrier run, on every replica: losses, parameters and BatchNorm buffers,
  Adam moments, the residual; every segment exchanged from inside the
  backward, where SyncBN's backward all-reduces run too;
- ``none``, ``bf16_ef`` and ``int8_ef`` (2 epochs) against the JAX
  package's segmented run on 2 of the 8 virtual CPU devices from the same
  init, within ``SPREAD`` times the JAX package's own spread from an init
  one ulp higher (tests/test_torch_port_comm_gloo.py's rule).

On the card (``cuda``, skipped here): AlexNet's segmented step at
``bucket_cap_mb: 25`` (three segments) replayed bitwise its barrier step.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_port_comm_gloo import BASE, CAP, SPREAD, SPREAD_LOSS_CAP, _residuals, _ulp_up  # noqa: E402
from test_torch_port_optim_train import _env  # noqa: E402
from test_torch_port_overlap import jax_segmented  # noqa: E402
from test_torch_port_zero1_gloo import jax_init  # noqa: E402

SPAWN_TIMEOUT_S = 400
ONE = dict(num_epochs=1, checkpoint_epoch=1)
CASES = {
    "none_step": dict(comm_hook="none", scan_steps=1),
    "none_cycle": dict(comm_hook="none", scan_steps=1, gradient_accumulation_steps=2, **ONE),
    "bf16_step": dict(comm_hook="bf16", scan_steps=1, **ONE),
    "topk_ef_step": dict(comm_hook="topk_ef", scan_steps=1, **ONE),
    "int8_ef_chunk": dict(comm_hook="int8_ef", scan_steps=4),
    "bf16_ef_accum_chunk": dict(comm_hook="bf16_ef", scan_steps=4, gradient_accumulation_steps=2),
}
AGAINST_JAX = ("none_step", "int8_ef_chunk", "bf16_ef_accum_chunk")


def _training(case, overlap):
    return dict(BASE, bucket_cap_mb=CAP, comm_overlap=overlap, **CASES[case])


def _name(case, overlap):
    return f"{case}_{'segmented' if overlap else 'barrier'}"


@pytest.fixture(scope="module")
def init():
    return jax_init(BASE)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, init):
    work = tmp_path_factory.mktemp("overlap_world2")
    jobs = []
    for case in CASES:
        for overlap in (True, False):
            name = _name(case, overlap)
            np.savez(work / f"{name}_init.npz", **{k: v.numpy() for k, v in init[2].items()})
            jobs.append({"kind": "run", "name": name, "path": "native",
                         "training": _training(case, overlap)})
    (work / "jobs.json").write_text(json.dumps(jobs))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_zero1_worker.py"), str(work)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return work


def _load(work, name, rank):
    out = {f"model/{k}": v for k, v in np.load(work / f"{name}_{rank}.npz").items()}
    out.update({f"opt/{k}": v for k, v in np.load(work / f"{name}_opt_{rank}.npz").items()})
    if (work / f"{name}_residual_{rank}.npz").exists():
        out["residual"] = np.load(work / f"{name}_residual_{rank}.npz")["vec"]
    with open(work / f"{name}_overlap_{rank}.json") as f:
        return out, json.load(f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_segmented_step_is_bitwise_the_barrier_step_world_2(world2, case):
    with open(world2 / f"{_name(case, True)}_history.json") as f:
        seg_history = json.load(f)
    with open(world2 / f"{_name(case, False)}_history.json") as f:
        barrier_history = json.load(f)
    key = ("train_loss", "test_loss", "test_accuracy", "train_samples")
    assert [[r[k] for k in key] for r in seg_history] == [[r[k] for k in key] for r in barrier_history]
    for rank in range(2):
        seg, overlap = _load(world2, _name(case, True), rank)
        barrier, off = _load(world2, _name(case, False), rank)
        assert off == {"meta": {"enabled": False, "segments": None, "reason": "disabled"},
                       "counts": None}
        assert overlap["meta"] == {"enabled": True, "segments": 4, "reason": None}
        assert overlap["counts"]["hook"] > 0 and overlap["counts"]["join"] == 0, overlap
        assert sorted(seg) == sorted(barrier) and ("residual" in seg) == case.startswith(
            ("topk_ef", "int8_ef", "bf16_ef"))
        for k in barrier:
            np.testing.assert_array_equal(seg[k], barrier[k], err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("case", AGAINST_JAX)
def test_the_segmented_run_matches_jax_world_2(cpu_devices, init, world2, case):
    training = _training(case, True)
    with open(world2 / f"{_name(case, True)}_history.json") as f:
        history = json.load(f)
    final, _ = _load(world2, _name(case, True), 0)
    params, mstate, _ = init
    ref = jax_segmented(training, params, mstate, cpu_devices[:2])
    alt = jax_segmented(training, _ulp_up(params), mstate, cpu_devices[:2])
    assert ref[3] == {"enabled": True, "segments": 4, "reason": None}
    ours = np.array([(r["train_loss"], r["test_loss"]) for r in history])
    theirs, other = np.array(ref[0]), np.array(alt[0])
    spread = {"losses": float(np.max(np.abs(other / theirs - 1))),
              "state": max(float(np.abs(alt[1][k].numpy() - ref[1][k].numpy()).max()) for k in ref[1])}
    got = {"losses": float(np.max(np.abs(ours / theirs - 1))),
           "state": max(float(np.abs(final[f"model/{k}"] - ref[1][k].numpy()).max()) for k in ref[1])}
    if training["comm_hook"] != "none":
        residual = _residuals(world2, _name(case, True), "native", training)
        spread["residual"] = float(np.abs(alt[2] - ref[2]).max())
        got["residual"] = float(np.abs(residual - ref[2]).max())
    detail = {k: (got[k], spread[k]) for k in got}
    assert 0 < spread["losses"] < SPREAD_LOSS_CAP and 0 < spread["state"], detail
    for k in got:
        assert got[k] <= SPREAD * spread[k], f"{case}: (port, JAX spread) {detail}"


# ---------------------------------------------------------- on the card --

@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("hook", ("none", "int8_ef"))
def test_alexnet_segmented_replay_is_bitwise_the_barrier_step(card, hook):
    """2 chunks of 2 AlexNet@224 steps (batch 16): the segmented replay,
    three segments on the side stream, against the barrier chunks run
    eagerly: parameters, moments and the residual bitwise."""
    from tpuddp_torch.data.transforms import make_train_augment
    from tpuddp_torch.models import AlexNet
    from tpuddp_torch.nn import CrossEntropyLoss
    from tpuddp_torch.optim import Adam
    from tpuddp_torch.parallel.ddp import DistributedDataParallel

    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8), rng.integers(0, 10, 16),
                np.ones(16, np.float32)) for _ in range(6)]
    out = {}
    for overlap in (True, False):
        torch.manual_seed(0)
        model = AlexNet(num_classes=10)
        gen = torch.Generator().manual_seed(1)
        ddp = DistributedDataParallel(
            model, Adam(model.parameters(), lr=1e-3), CrossEntropyLoss(), device="cuda",
            augment=make_train_augment(size=224, flip=True, generator=gen), generator=gen,
            comm_hook=hook, comm_overlap=overlap)
        ddp._graph_replay = overlap
        torch.cuda.manual_seed(7)
        for c in range(3):
            ddp.train_step_many(batches[2 * c:2 * c + 2])
        torch.cuda.synchronize()
        state = [p.detach().clone() for p in model.parameters()]
        state += [t.clone() for st in ddp.optimizer.state.values() for t in st.values() if torch.is_tensor(t)]
        out[overlap] = state + ([] if ddp.residual is None else [ddp.residual.clone()])
        if overlap:
            assert ddp.comm_overlap_meta["segments"] == 3 and ddp._overlap.counts["join"] == 0
    for a, b in zip(out[True], out[False]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
