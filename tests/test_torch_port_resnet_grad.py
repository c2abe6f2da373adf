"""The port's ResNets against the JAX package on the CPU: one gradient
against ``jax.grad`` (``resnet18_small``, ``resnet50``), in eval mode
(through the running statistics) and in train mode. Tolerances and
helpers: tests/test_torch_port_resnet.py."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp.nn.core import Context

from tpuddp_torch.models.convert import jax_places, state_dict_from_jax
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.nn.norm import batch_weights

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_resnet import (  # noqa: E402
    COUNTS, RTOL, _children, _close, _gradient_batch, _jax_init, _jax_loss,
    _jax_runs, _np_tree, _nhwc, _port, _port_loss, _within,
)


@pytest.mark.parametrize("name", ["resnet18_small", "resnet50"])
def test_one_gradient_matches_jax_grad_eval_mode(name):
    """A weighted cross-entropy through the running statistics: the loss
    and every parameter's gradient against ``jax.grad``."""
    torch.set_num_threads(2)
    jax_model, params, mstate = _jax_init(name)
    x, y, w = _gradient_batch()
    model = _port(name, train=False)
    loss = _port_loss(model, x, y, w)
    loss.backward()
    ref_loss, ref_grads = jax.value_and_grad(_jax_loss(jax_model, mstate, x, y, w, False))(params)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=RTOL)
    ref = state_dict_from_jax(name, _np_tree(ref_grads))
    for pname, p in model.named_parameters():
        _close(p.grad.numpy(), ref[pname].numpy(), pname)


def test_one_gradient_matches_jax_grad_train_mode_child_by_child():
    """``resnet18_small`` in train mode (BatchNorm on the batch's
    statistics, one row padded out), child by child of the JAX
    ``Sequential``: each child's output from the port's own input to it,
    and the JAX package's VJP of that child at that input with the port's
    cotangent against the port's parameter gradients. Held whole, the
    train-mode gradient of the deep layers moves by up to 4% under the
    port's forward rounding (float32 convolutions in another order, 5e-6
    relative at ``layer4``), a move the JAX package's own spread does not
    sample; child by child it agrees to rtol 1e-4."""
    torch.set_num_threads(2)
    name = "resnet18_small"
    jax_model, params, mstate = _jax_init(name)
    x, y, w = _gradient_batch()
    model = _port(name, train=True)
    children = _children(model)
    assert len(children) == COUNTS[name][0]
    h, ins, outs = torch.from_numpy(x).permute(0, 3, 1, 2), [], []
    with batch_weights(model, torch.from_numpy(w)):
        for child in children:
            ins.append(h)
            h = child(h)
            h.retain_grad()
            outs.append(h)
        loss = CrossEntropyLoss()(h, torch.from_numpy(y), torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(
        loss.item(), float(_jax_loss(jax_model, mstate, x, y, w, True)(params)), rtol=RTOL)
    named = dict(model.named_parameters())
    places = jax_places(name, model)
    ctx = Context(train=True, sample_weight=jnp.asarray(w))
    for k, child in enumerate(jax_model.layers):
        out, vjp = jax.vjp(lambda p, hk: child.apply(p, mstate[k], hk, ctx)[0],
                           params[k], jnp.asarray(_nhwc(ins[k].detach().numpy())))
        _close(_nhwc(outs[k].detach().numpy()), out, f"child {k} output")
        grads, _ = vjp(jnp.asarray(_nhwc(outs[k].grad.numpy())))
        for pname in (n for n, (child_k, _) in places.items() if child_k == k):
            ref = grads
            for key in places[pname][1]:
                ref = ref[key]
            ref = np.asarray(ref)
            ref = ref.transpose(3, 2, 0, 1) if ref.ndim == 4 else ref.T if ref.ndim == 2 else ref
            _close(named[pname].grad.numpy(), ref, pname)


def test_one_gradient_matches_jax_grad_train_mode_whole():
    """``resnet50`` in train mode, whole: at 32 px its ``layer4``
    BatchNorms see 3 real values per channel, and the JAX package's own
    gradient moves by up to 1.4 times its largest element between its
    eager and jitted runs or from an init one ulp higher; the port is held
    to SPREAD times that move (the loss too)."""
    torch.set_num_threads(2)
    name = "resnet50"
    jax_model, params, mstate = _jax_init(name)
    x, y, w = _gradient_batch()
    model = _port(name, train=True)
    loss = _port_loss(model, x, y, w)
    loss.backward()
    (ref_loss, ref_grads), (loss_spread, spread) = _jax_runs(
        jax.value_and_grad(_jax_loss(jax_model, mstate, x, y, w, True)), params)
    _within(np.float32(loss.item()), ref_loss, loss_spread, "loss")
    ref, moved = (state_dict_from_jax(name, g) for g in (ref_grads, spread))
    for pname, p in model.named_parameters():
        _within(p.grad.numpy(), ref[pname].numpy(), moved[pname].numpy(), pname)
