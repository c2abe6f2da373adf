"""The managed path's drain at world 2 on one host (two Gloo processes on
the CPU): with ``training.snapshot`` the train pass polls rank 0's flag,
agreed after each cycle; ``preempt@step=N`` ends both ranks with exit 75
and one ``state_{epoch}_s{step}.npz`` (the per-leaf residual, ZeRO-1's
gathered ``opt_state``, the v4 cursor with the global rows seen), and the
auto-resumed run is bitwise an uninterrupted one (epoch rows, the final
state file), ``bf16_ef`` with and without ZeRO-1. Mirrors
``tests/test_snapshot.py``'s managed drain.

Tolerances: bitwise (the same batches, random streams and arithmetic)."""

import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_port_snapshot_gloo import (  # noqa: E402
    _assert_files_equal, _drain_lines, _epochs, _records, _run, _yaml,
)

from tpuddp_torch.training import checkpoint as ckpt  # noqa: E402

# a managed epoch row's fields that are neither the clock nor the counters
ROW = ("epoch", "train_loss", "test_loss", "test_accuracy", "train_samples", "test_samples",
       "comm_hook", "grad_comm_bytes_per_update", "world_size")


@pytest.mark.parametrize("name,extra", [("bf16_ef", {}),
                                        ("zero1", {"weight_update_sharding": True})])
def test_a_world_2_managed_drain_resumes_bitwise(tmp_path, name, extra):
    extra = dict(extra, snapshot={"every_steps": 3})
    straight, drained = str(tmp_path / "straight"), str(tmp_path / "drained")
    s = _run(_yaml(tmp_path / "s.yaml", straight, **extra), "train_accelerate",
             TPUDDP_WORLD_SIZE="2")
    assert s.returncode == 0, s.stdout[-2000:] + s.stderr[-3000:]
    path = _yaml(tmp_path / "d.yaml", drained, **extra)
    d = _run(path, "train_accelerate", TPUDDP_WORLD_SIZE="2", TPUDDP_FAULT="preempt@step=8")
    assert d.returncode == 75, d.stdout[-2000:] + d.stderr[-3000:]
    # the flag rises as host batch 8 (epoch 1's third) is staged; the
    # cycle boundary after it agrees: epoch 1 stops after step 3
    snaps = sorted(f for f in os.listdir(drained) if re.fullmatch(r"state_\d+_s\d+\.npz", f))
    assert len(snaps) == 1 and snaps[0].startswith("state_1_s"), snaps
    step = int(re.search(r"_s(\d+)", snaps[0]).group(1))
    cursor = ckpt.read_cursor(os.path.join(drained, snaps[0]))
    assert cursor["step"] == step and cursor["acc"]["['n_seen']"] == 8 * step * 2  # global rows
    preempts = [r for r in _records(drained) if r.get("event") == "preempt"]
    assert len(preempts) == 1 and preempts[0]["snapshot_step"] == step
    lines = _drain_lines(d.stderr)
    assert sorted(lines) == [0, 1]
    assert len({re.search(r"(\d+) exchanges", line).group(1) for line in lines.values()}) == 1
    r = _run(path, "train_accelerate", TPUDDP_WORLD_SIZE="2", TPUDDP_AUTO_RESUME="1")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert f"Resumed from step snapshot: epoch 1 step {step}." in r.stdout
    assert _epochs(drained, ROW) == _epochs(straight, ROW)
    _assert_files_equal(os.path.join(drained, "state_1.npz"), os.path.join(straight, "state_1.npz"))
