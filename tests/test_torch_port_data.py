"""Data path of the PyTorch port (tpuddp_torch) against the JAX package, on
the CPU: sampler order, loader batches, the synthetic CIFAR-10 stand-in,
device transforms and the weighted loss. Inputs come from numpy seeds and go
through both packages."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.data import transforms as jax_tf
from tpuddp.data.synthetic import SyntheticClassification as JaxSynthetic
from tpuddp.data.synthetic import synthetic_uint8_datasets as jax_synthetic_uint8
from tpuddp.nn.loss import cross_entropy as jax_cross_entropy
from tpuddp.parallel import make_mesh
from tpuddp.parallel.sampler import DistributedSampler as JaxSampler

from tpuddp_torch.data import ShardedDataLoader, flip_for, load_datasets_for
from tpuddp_torch.data import transforms as tf
from tpuddp_torch.data.loader import pad_batch
from tpuddp_torch.nn import cross_entropy
from tpuddp_torch.parallel.sampler import DistributedSampler

# Transforms: float32 bilinear taps summed in another order -> ~1e-6 apart.
TRANSFORM_ATOL = 1e-5
# Loss: float32 log-sum-exp in two libraries.
LOSS_RTOL = 1e-6


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("shuffle", [True, False])
def test_sampler_order_matches_jax(world, shuffle):
    """Exact equality of every rank's indices over several epochs, padding
    by wrap included (103 is not a multiple of 2 or 3)."""
    for rank in range(world):
        ours = DistributedSampler(103, num_replicas=world, rank=rank, shuffle=shuffle, seed=5)
        ref = JaxSampler(103, num_replicas=world, rank=rank, shuffle=shuffle, seed=5)
        for epoch in range(3):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            np.testing.assert_array_equal(ours.local_indices(), ref.local_indices())


def test_sampler_order_is_not_torch_distributed_sampler():
    """The port keeps the JAX order; torch's DistributedSampler permutes
    with torch.randperm and gives another one."""
    from torch.utils.data import DistributedSampler as TorchSampler

    ours = DistributedSampler(103, num_replicas=2, rank=0, seed=5)
    theirs = TorchSampler(range(103), num_replicas=2, rank=0, seed=5)
    assert list(iter(ours)) != list(iter(theirs))


@pytest.mark.parametrize("world", [1, 2, 3])
def test_loader_batches_match_jax_slices(world, cpu_devices):
    """Rank r's batch is exactly the r-th per-replica slice of the JAX
    loader's batch: same rows, same padding, same weights, every epoch."""
    ds = JaxSynthetic(n=50, shape=(4, 4, 3), seed=3)
    batch = 8
    ref = JaxLoader(ds, batch, make_mesh(cpu_devices[:world]), shuffle=True, seed=2)
    ours = [ShardedDataLoader(ds, batch, r, world, shuffle=True, seed=2) for r in range(world)]
    for epoch in range(2):
        ref.set_epoch(epoch)
        for loader in ours:
            loader.set_epoch(epoch)
        ref_batches = list(ref)
        assert all(len(loader) == len(ref) for loader in ours)
        for r, loader in enumerate(ours):
            for (x, y, w), (rx, ry, rw) in zip(loader, ref_batches):
                sl = slice(r * batch, (r + 1) * batch)
                np.testing.assert_array_equal(x, rx[sl])
                np.testing.assert_array_equal(y, ry[sl])
                np.testing.assert_array_equal(w, rw[sl])
    assert ours[0].probe_fingerprint(x).startswith("replica 0: [")


def test_pad_batch_marks_padding():
    x = np.arange(3 * 2, dtype=np.uint8).reshape(3, 2)
    px, py, pw = pad_batch(x, np.array([4, 5, 6], np.int32), 5)
    np.testing.assert_array_equal(pw, [1, 1, 1, 0, 0])
    np.testing.assert_array_equal(py, [4, 5, 6, 0, 0])
    np.testing.assert_array_equal(px[3:], np.repeat(x[:1], 2, axis=0))
    with pytest.raises(ValueError):
        pad_batch(x, np.zeros(3, np.int32), 2)


def test_cifar10_falls_back_to_jax_synthetic_stand_in(tmp_path, monkeypatch):
    """No CIFAR-10 staged and no download: the stand-in is the JAX package's
    synthetic uint8 set, array for array."""
    monkeypatch.delenv("TPUDDP_DATA", raising=False)
    monkeypatch.chdir(tmp_path)  # no ./data here
    train, test = load_datasets_for({"dataset": "cifar10", "data_root": str(tmp_path / "none")})
    ref_train, ref_test = jax_synthetic_uint8(2048, 512)
    for ours, ref in ((train, ref_train), (test, ref_test)):
        assert ours.images.dtype == np.uint8 and ours.images.shape[1:] == (32, 32, 3)
        np.testing.assert_array_equal(ours.images, ref.images)
        np.testing.assert_array_equal(ours.labels, ref.labels)


def test_synthetic_dataset_sizes_and_digits_refused(monkeypatch):
    """Digits load from the arrays in the repository, with scikit-learn
    unimportable (tests/test_torch_port_digits.py holds the arrays against
    the JAX package's); an unknown dataset is refused."""
    train, test = load_datasets_for({"dataset": "synthetic", "synthetic_n": [64, 16]})
    assert (len(train), len(test)) == (64, 16)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    train, test = load_datasets_for({"dataset": "digits"})
    assert (len(train), len(test)) == (1437, 360)
    with pytest.raises(ValueError):
        load_datasets_for({"dataset": "imagenet"})
    assert flip_for({}) and not flip_for({"dataset": "digits"}) and not flip_for({"flip": False})


def _images(n=3, seed=0):
    return np.random.RandomState(seed).randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)


@pytest.mark.parametrize("size", [64, 224])
def test_resize_matches_jax_image_resize(size):
    x = _images().astype(np.float32) / 255.0
    ours = tf.resize(torch.from_numpy(x), size).numpy()
    ref = np.asarray(jax_tf.resize(jnp.asarray(x), size))
    assert ours.shape == (3, size, size, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TRANSFORM_ATOL)


@pytest.mark.parametrize("size", [64, 224])
def test_train_augment_matches_jax_with_the_same_flip_mask(size):
    """Flip, normalize, resize — the JAX order — with one mask fed to both."""
    x = _images(4)
    mask = np.array([True, False, True, False])
    ours = tf.make_train_augment(size=size, flip=True)(
        torch.from_numpy(x), flip_mask=torch.from_numpy(mask)
    ).numpy()
    xf = jax_tf._to_float(jnp.asarray(x))
    xf = jnp.where(jnp.asarray(mask)[:, None, None, None], xf[:, :, ::-1, :], xf)
    ref = np.asarray(jax_tf.resize(jax_tf.normalize(xf), size))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TRANSFORM_ATOL)


@pytest.mark.parametrize("size", [None, 64])
def test_eval_transform_matches_jax(size):
    x = _images(2, seed=1)
    ours = tf.make_eval_transform(size=size)(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_tf.make_eval_transform(size=size)(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TRANSFORM_ATOL)


def test_flip_rate_and_direction():
    """Each image flips with probability 1/2 (a binomial 5-sigma band over
    20000 draws), along W, and the generator makes the masks reproducible."""
    x = torch.zeros(20000, 2, 2, 1)
    mask = tf.flip_mask_like(x, torch.Generator().manual_seed(1))
    rate = mask.float().mean().item()
    assert abs(rate - 0.5) < 5 * (0.25 / 20000) ** 0.5
    again = tf.flip_mask_like(x, torch.Generator().manual_seed(1))
    assert torch.equal(mask, again)
    img = torch.arange(2 * 3 * 4 * 1, dtype=torch.float32).reshape(2, 3, 4, 1)
    out = tf.horizontal_flip(img, torch.tensor([True, False]))
    assert torch.equal(out[0], img[0].flip(1)) and torch.equal(out[1], img[1])


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_weighted_cross_entropy_matches_jax(reduction):
    rng = np.random.RandomState(3)
    logits = rng.randn(6, 10).astype(np.float32)
    labels = rng.randint(0, 10, 6).astype(np.int32)
    weights = np.array([1, 1, 1, 1, 0, 0], np.float32)
    ours = cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(weights), reduction
    ).numpy()
    ref = np.asarray(jax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), reduction, jnp.asarray(weights)
    ))
    np.testing.assert_allclose(ours, ref, rtol=LOSS_RTOL, atol=1e-7)


def test_all_padding_batch_has_zero_loss_and_gradient():
    logits = torch.randn(4, 10, requires_grad=True)
    loss = cross_entropy(logits, torch.zeros(4, dtype=torch.int64), torch.zeros(4))
    loss.backward()
    assert loss.item() == 0.0 and torch.all(logits.grad == 0)
