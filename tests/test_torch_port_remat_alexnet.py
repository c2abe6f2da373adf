"""Remat on AlexNet (``tpuddp_torch/nn/remat.py``), on the CPU: at 64 px,
batch 4 (the last row padding), flips and dropout on, one DDP step with
``remat=True`` is bitwise the plain step from one state and one random
stream (loss, parameters, gradients, Adam's moments), and the random
stream is left where the plain step leaves it. Dropout's draws are the
forward's, recorded and taken again by the backward's recompute; nothing
reads or sets the generator."""

import numpy as np
import pytest
import torch

from tpuddp_torch.data.transforms import make_train_augment
from tpuddp_torch.models import AlexNet
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.optim import Adam
from tpuddp_torch.parallel.ddp import DistributedDataParallel

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def steps():
    torch.manual_seed(0)
    init = AlexNet(num_classes=10).state_dict()
    rng = np.random.RandomState(3)
    batch = (rng.randint(0, 256, size=(4, 32, 32, 3)).astype(np.uint8),
             rng.randint(0, 10, size=4).astype(np.int64), np.array([1, 1, 1, 0], np.float32))
    out = {}
    for remat in (False, True):
        model = AlexNet(num_classes=10)
        model.load_state_dict(init)
        gen = torch.Generator().manual_seed(1)
        ddp = DistributedDataParallel(model, Adam(model.parameters(), lr=1e-3), CrossEntropyLoss(),
                                      augment=make_train_augment(size=64, flip=True, generator=gen),
                                      device="cpu", generator=gen, remat=remat)
        torch.manual_seed(5)  # the dropout stream
        sums = ddp.train_step(batch)
        state = {f"param/{k}": p.detach().clone() for k, p in model.named_parameters()}
        state.update({f"grad/{k}": p.grad.clone() for k, p in model.named_parameters()})
        for i, st in enumerate(ddp.optimizer.state.values()):
            state.update({f"moment/{i}/{k}": t.clone() for k, t in st.items()
                          if torch.is_tensor(t) and t.numel() > 1})
        out[remat] = dict(sums=sums, state=state, after=torch.rand(4))
    return out


def test_alexnet_remat_step_is_bitwise_plain(steps):
    plain, rematted = steps[False], steps[True]
    torch.testing.assert_close(rematted["sums"], plain["sums"], rtol=0, atol=0)
    assert plain["state"].keys() == rematted["state"].keys()
    for key, value in plain["state"].items():
        torch.testing.assert_close(rematted["state"][key], value, rtol=0, atol=0, msg=key)
    assert torch.isfinite(plain["sums"]).all()


def test_alexnet_remat_leaves_the_random_stream_where_plain_does(steps):
    torch.testing.assert_close(steps[True]["after"], steps[False]["after"], rtol=0, atol=0)


def test_alexnet_dropout_was_on(steps):
    """The classifier's gradient rows of dropped features are zero in both
    runs: the masks took effect (and are the same masks)."""
    grad = steps[False]["state"]["grad/classifier.4.weight"]
    assert (grad.abs().sum(0) == 0).any()
