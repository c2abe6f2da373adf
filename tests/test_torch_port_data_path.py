"""The port's host data path on the CPU: the native row gather (built here
with g++), PrefetchLoader's stream and threads, the staging pipeline, and a
toy run under the default pipeline against ``pipeline: false``.

The gather, the prefetched streams and the pipeline's batches are held
bitwise (they only move bytes); the pipeline on/off runs bitwise too (the
same batches in the same order through the same arithmetic). Streams are
also held bitwise against the JAX package's ``PrefetchLoader``."""

import os
import sys
import threading
import time
import traceback
from functools import partial

import numpy as np
import pytest
import torch

from tpuddp.data import PrefetchLoader as JaxPrefetchLoader
from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.data.synthetic import SyntheticClassification as JaxSynthetic
from tpuddp.parallel import make_mesh

from tpuddp_torch import config as cfg_lib
from tpuddp_torch.data import DataLoader, PrefetchLoader, ShardedDataLoader, _native
from tpuddp_torch.data import loader as loader_lib
from tpuddp_torch.data.synthetic import SyntheticClassification
from tpuddp_torch.parallel.spawn import run_ddp_training
from tpuddp_torch.train_accelerate import basic_accelerate_training
from tpuddp_torch.train_native import build_training
from tpuddp_torch.training import pipeline as pipeline_lib
from tpuddp_torch.training.loop import run_training_loop
from tpuddp_torch.utils import batching

JOIN_S = 5  # PrefetchLoader joins each thread with this timeout


def _rows(dtype, n=300, shape=(4, 4, 3), seed=0):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, size=(n, *shape)).astype(np.uint8)
    return rng.randn(n, 7).astype(np.float32)


def test_native_gather_is_bitwise_numpy_on_its_threads():
    """4 MiB of 16 KiB rows: the C side copies on 4 threads."""
    src = _rows(np.uint8, n=1000, shape=(64, 64, 4), seed=3)
    idx = np.random.RandomState(1).randint(0, len(src), size=256)
    np.testing.assert_array_equal(_native.gather_rows(src, idx, pad_rows=300),
                                  _numpy_gather(src, idx, 300))


def _numpy_gather(src, idx, pad_rows):
    x = src[idx]
    if pad_rows > len(idx):
        x = np.concatenate([x, np.repeat(x[:1], pad_rows - len(idx), axis=0)])
    return x


# ------------------------------------------------------------------ gather --

@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8_nhwc", "float32_rows"])
@pytest.mark.parametrize("n_idx,pad_rows", [(128, 128), (200, 256), (5, 8), (1, 1)])
def test_native_gather_is_bitwise_numpy(dtype, n_idx, pad_rows):
    """Bitwise equal to numpy's ``src[idx]`` with the tail padded by the
    first gathered row."""
    src = _rows(dtype)
    idx = np.random.RandomState(n_idx).randint(0, len(src), size=n_idx)
    got = _native.gather_rows(src, idx, pad_rows=pad_rows)
    want = _numpy_gather(src, idx, pad_rows)
    assert got.dtype == src.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_ragged_tail_pads_with_the_first_row():
    src = _rows(np.uint8)
    got = _native.gather_rows(src, [7, 3, 9], pad_rows=6)
    for row in range(3, 6):
        np.testing.assert_array_equal(got[row], src[7])


@pytest.mark.parametrize("bad", [-1, 300, 10**9])
def test_bad_index_raises_index_error(bad):
    with pytest.raises(IndexError, match=str(bad)):
        _native.gather_rows(_rows(np.uint8), [0, bad, 2], pad_rows=4)


def test_gather_refuses_inputs_the_c_side_cannot_take():
    with pytest.raises(ValueError, match="C-contiguous"):
        _native.gather_rows(_rows(np.float32)[:, ::2], [0], pad_rows=1)
    with pytest.raises(ValueError, match="at least one index"):
        _native.gather_rows(_rows(np.float32), [], pad_rows=4)


def test_failed_build_raises_with_the_compilers_output(tmp_path):
    broken = tmp_path / "broken.cpp"
    broken.write_text('extern "C" int f() { return undeclared_name; }\n')
    with pytest.raises(RuntimeError, match="undeclared_name"):
        _native.build(broken)
    fresh = tmp_path / "gather.cpp"  # a source no library was built from yet
    fresh.write_text(_native.SOURCE.read_text() + "\n// a new hash\n")
    with pytest.raises(RuntimeError, match="not found"):
        _native.build(fresh, cxx="no-such-compiler-tpuddp")
    lib = _native.Library(broken)
    with pytest.raises(RuntimeError, match="undeclared_name"):
        lib.gather_rows(_rows(np.uint8), [0], pad_rows=1)


def test_library_is_keyed_by_source_flags_and_isa():
    path, _ = _native.build()
    again, log = _native.build()
    assert again == path and log == ""
    assert path.parent == _native.BUILD_DIR and path.name.startswith("libtpuddp_gather-")
    assert _native.isa_tag().startswith(os.uname().machine)
    assert _native.load().tpuddp_torch_gather_abi_version() == _native.ABI_VERSION


class _NoArrays:
    """A dataset without ``.images``/``.labels``: numpy's path."""

    def __init__(self, ds):
        self._ds = ds

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, i):
        return self._ds[i]


def test_fetch_padded_routes_and_both_paths_agree(monkeypatch):
    ds = SyntheticClassification(n=40, shape=(4, 4, 3), seed=1)
    calls = []
    real = _native.gather_rows
    monkeypatch.setattr(_native, "gather_rows", lambda *a, **k: calls.append(1) or real(*a, **k))
    idx = np.array([5, 2, 39])
    native = loader_lib._fetch_padded(ds, idx, 8)
    assert calls == [1]
    plain = loader_lib._fetch_padded(_NoArrays(ds), idx, 8)
    assert calls == [1]
    for a, b in zip(native, plain):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    x, y, w = loader_lib._fetch_padded(ds, np.array([], np.int64), 0)
    assert calls == [1] and len(x) == len(y) == len(w) == 0


def test_batch_nbytes_counts_one_batchs_inputs():
    ds = SyntheticClassification(n=40, shape=(4, 4, 3), seed=1)
    assert ShardedDataLoader(ds, 8, 0, 2).batch_nbytes == 8 * 48 * ds.images.itemsize
    assert DataLoader(ds, 5).batch_nbytes == 5 * 48 * ds.images.itemsize
    assert DataLoader(_NoArrays(ds), 5).batch_nbytes is None


# ---------------------------------------------------------- PrefetchLoader --

def _sharded(rank=1, world=2, n=70, batch=8):
    ds = SyntheticClassification(n=n, shape=(4, 4, 3), seed=4)
    return ShardedDataLoader(ds, batch, rank, world, shuffle=True, seed=3)


@pytest.mark.parametrize("workers", [1, 2, 4])
@pytest.mark.parametrize("depth", [1, 2])
def test_prefetch_stream_is_the_inner_loaders(workers, depth):
    inner, outer = _sharded(), PrefetchLoader(_sharded(), depth=depth, workers=workers)
    assert len(outer) == len(inner) and outer.batch_nbytes == inner.batch_nbytes
    for epoch in range(2):
        inner.set_epoch(epoch)
        outer.set_epoch(epoch)
        got, want = list(outer), list(inner)
        assert len(got) == len(want) == len(inner)
        for a, b in zip(got, want):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("rank", [0, 1])
def test_prefetch_matches_the_jax_prefetch_slices(cpu_devices, rank):
    """Rank r's prefetched batch is the r-th slice of the JAX package's
    prefetched batch (``PrefetchLoader(ShardedDataLoader)``, 2 workers)."""
    ds = JaxSynthetic(n=70, shape=(4, 4, 3), seed=4)
    batch = 8
    ref = JaxPrefetchLoader(JaxLoader(ds, batch, make_mesh(cpu_devices[:2]), shuffle=True, seed=3),
                            workers=2)
    ours = PrefetchLoader(ShardedDataLoader(ds, batch, rank, 2, shuffle=True, seed=3), workers=2)
    sl = slice(rank * batch, (rank + 1) * batch)
    for epoch in range(2):
        ref.set_epoch(epoch)
        ours.set_epoch(epoch)
        ref_batches = list(ref)
        assert len(ref_batches) == len(ours)
        for got, want in zip(ours, ref_batches):
            for u, v in zip(got, want):
                np.testing.assert_array_equal(u, v[sl])


def test_prefetch_depth_is_capped_by_the_staging_budget():
    inner = _sharded()
    huge = type("Huge", (), {"batch_nbytes": batching.STAGE_BYTES_BUDGET // 2 + 1,
                             "__len__": lambda self: 0})()
    assert PrefetchLoader(huge, depth=8).effective_depth() == 1
    assert PrefetchLoader(inner, depth=3).effective_depth() == 3
    assert batching.resolve_fuse(None, cap=5) == 5


class _FailingPlan:
    """A loader whose batch 2 raises in ``explode``."""

    def __init__(self, steps=6):
        self.steps = steps

    def __len__(self):
        return self.steps

    def set_epoch(self, epoch):
        pass

    def make_batch_plan(self):
        def fetch(s):
            if s == 2:
                explode()
            return np.full(3, s)

        def explode():
            raise KeyError("batch 2 is broken")

        return self.steps, fetch

    def __iter__(self):
        steps, fetch = self.make_batch_plan()
        return (fetch(s) for s in range(steps))


def _tpuddp_threads():
    return [t for t in threading.enumerate() if t.name.startswith("tpuddp") and t.is_alive()]


def _wait_for_no_threads(timeout=JOIN_S):
    deadline = time.monotonic() + timeout
    while _tpuddp_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    return _tpuddp_threads()


@pytest.mark.parametrize("workers", [1, 3])
def test_worker_exception_surfaces_with_its_frame(workers):
    seen = []
    with pytest.raises(KeyError, match="batch 2 is broken") as info:
        for batch in PrefetchLoader(_FailingPlan(), workers=workers):
            seen.append(int(batch[0]))
    assert seen == [0, 1]
    frames = [f.name for f in traceback.extract_tb(info.value.__traceback__)]
    assert "explode" in frames and ("work" if workers > 1 else "produce") in frames
    assert not _wait_for_no_threads()


@pytest.mark.parametrize("workers", [1, 2])
def test_abandoned_iteration_reaps_every_thread(workers):
    assert not _wait_for_no_threads()
    it = iter(PrefetchLoader(_sharded(n=400), depth=2, workers=workers))
    next(it)
    assert _tpuddp_threads()
    it.close()  # the consumer walks away mid-epoch
    assert not _wait_for_no_threads()


def test_pool_stress_keeps_order_under_fast_switching():
    """More workers than cores, a tiny switch interval: the pooled stream
    is still the inner loader's, in order."""
    inner = _sharded(rank=0, world=1, n=600, batch=4)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = list(PrefetchLoader(inner, depth=4, workers=4 * (os.cpu_count() or 2)))
    finally:
        sys.setswitchinterval(old)
    want = list(inner)
    assert len(got) == len(want) == 150
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[0], b[0])
    assert not _wait_for_no_threads()


# ---------------------------------------------------------------- pipeline --

def test_resolve_pipeline_matches_the_jax_rules():
    assert pipeline_lib.resolve_pipeline(None) == pipeline_lib.DEFAULT
    assert pipeline_lib.resolve_pipeline(True) == pipeline_lib.DEFAULT
    assert pipeline_lib.resolve_pipeline(False) == pipeline_lib.SYNCHRONOUS
    cfg = pipeline_lib.resolve_pipeline({"depth": 4, "host_workers": 0})
    assert (cfg.depth, cfg.host_workers, cfg.sync_readback) == (4, 0, False)
    with pytest.raises(ValueError, match="did you mean 'depth'"):
        pipeline_lib.resolve_pipeline({"dpeth": 4})
    with pytest.raises(ValueError, match="host_workers"):
        pipeline_lib.resolve_pipeline({"host_workers": -1})
    with pytest.raises(NotImplementedError, match="Queue 1 item 8: async pipeline"):
        pipeline_lib.resolve_pipeline({"device_augment": False})
    assert pipeline_lib.staging_depth_for(3, batching.STAGE_BYTES_BUDGET) == 1
    assert pipeline_lib.staging_depth_for(3, None) == 3


class _Counting:
    """A loader that counts the host batches drawn from it."""

    def __init__(self, inner):
        self.inner, self.drawn = inner, 0

    def __len__(self):
        return len(self.inner)

    def set_epoch(self, epoch):
        self.inner.set_epoch(epoch)

    def __iter__(self):
        for batch in self.inner:
            self.drawn += 1
            yield batch


@pytest.mark.parametrize("cfg,ahead", [
    (pipeline_lib.DEFAULT, 2), (pipeline_lib.PipelineConfig(depth=1), 1),
    (pipeline_lib.SYNCHRONOUS, 0),
])
def test_staged_loader_runs_depth_batches_ahead(cfg, ahead):
    inner = _Counting(_sharded())
    probed = []
    staged = pipeline_lib.StagedLoader(inner, "cpu", cfg, probe=lambda i, b: probed.append(i))
    it = iter(staged)
    x, y, w = next(it)
    assert inner.drawn == 1 + ahead
    assert x.dtype == torch.float32 and y.dtype == torch.int64 and w.dtype == torch.float32
    rest = list(it)
    assert probed == list(range(len(inner))) and staged.stall.total > 0.0
    for (a, b, c), (u, v, t) in zip([(x, y, w)] + rest, _sharded()):
        assert torch.equal(a, torch.from_numpy(u)) and torch.equal(c, torch.from_numpy(t))
        assert torch.equal(b, torch.from_numpy(v.astype(np.int64)))


def test_to_device_passes_staged_tensors_through():
    t = torch.arange(4)
    assert pipeline_lib.to_device(t, torch.device("cpu")) is t
    assert pipeline_lib.to_device(t, torch.device("cpu"), torch.float32).dtype == torch.float32
    batch = pipeline_lib.stage_batch((np.zeros((2, 3), np.uint8), np.array([1, 2], np.int32),
                                      np.ones(2, np.float32)), torch.device("cpu"))
    again = pipeline_lib.stage_batch(batch, torch.device("cpu"))
    assert all(a is b for a, b in zip(batch, again))


@pytest.mark.cuda
def test_staged_copies_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    dev = torch.device("cuda", 0)
    host = [(np.random.RandomState(s).randint(0, 256, (128, 32, 32, 3)).astype(np.uint8),
             np.arange(128, dtype=np.int32), np.ones(128, np.float32)) for s in range(5)]
    staged = list(pipeline_lib.StagedLoader(host, dev, pipeline_lib.DEFAULT))
    torch.cuda.synchronize()
    for (x, y, w), (hx, hy, hw) in zip(staged, host):
        assert x.device == dev and torch.equal(x.cpu(), torch.from_numpy(hx))
        assert torch.equal(y.cpu(), torch.from_numpy(hy.astype(np.int64)))


# --------------------------------------------------- pipeline on and off ----

TOY = dict(cfg_lib.TRAINING_DEFAULTS, model="toy_cnn", dataset="synthetic", synthetic_n=(100, 40), train_batch_size=16,
           test_batch_size=16, num_epochs=2, checkpoint_epoch=5, image_size=None, seed=5,
           sync_bn=True, flip=True)


def _native_worker(rank, world_size, save_dir, optional_args, training):
    torch.set_num_threads(2)
    ddp, train_loader, test_loader, base_seed = build_training(rank, world_size, training, "cpu")
    history = run_training_loop(
        ddp, train_loader, test_loader, None, num_epochs=training["num_epochs"],
        base_seed=base_seed, pipeline=training["pipeline"], log=lambda *_: None,
    )
    return history, {k: v.clone() for k, v in ddp.model.state_dict().items()}


@pytest.mark.parametrize("accum", [1, 2])
def test_pipeline_on_and_off_are_bitwise_equal(accum):
    runs = {}
    for pipeline in (None, False):
        training = dict(TOY, pipeline=pipeline, gradient_accumulation_steps=accum)
        runs[pipeline] = run_ddp_training(
            partial(_native_worker, training=training), 1, None, {}, backend="cpu"
        )
    (h_on, sd_on), (h_off, sd_off) = runs[None], runs[False]
    for a, b in zip(h_on, h_off):
        assert (a["train_loss"], a["test_loss"]) == (b["train_loss"], b["test_loss"])
        assert a["pipeline"] != b["pipeline"] and a["host_stall_s"] >= 0.0
    for k in sd_on:
        assert torch.equal(sd_on[k], sd_off[k]), k


def test_managed_pipeline_on_and_off_are_equal():
    losses = {}
    for pipeline in (None, False):
        training = dict(TOY, pipeline=pipeline, model="toy_mlp", sync_bn=False)
        history = run_ddp_training(
            partial(basic_accelerate_training, training=training, device="cpu"),
            1, None, {}, backend="cpu",
        )
        losses[pipeline] = [(r["train_loss"], r["test_loss"], r["test_accuracy"]) for r in history]
    assert losses[None] == losses[False]
