"""The JAX package's own AlexNet epochs per gradient comm hook: the
reference for how far a hook moves the loss of
``configs/cifar10_alexnet_tpu.yaml``'s block (AlexNet at 224 px, batch
128, Adam lr 1e-3) on the seeded synthetic stand-in (2,048 / 512 images).

    python tools/jax_hook_epochs.py none int8_ef [--epochs 1]

Runs the JAX package's native worker (``train_native.basic_ddp_training_loop``)
on one device of the default JAX backend, one step per batch, and prints
its epoch lines, then one JSON line per hook with its epochs' losses. The
PyTorch port's ``chip_smoke.py`` (phase 12) cites it for the departure of
int8_ef's first epoch from the float32 run.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import train_native  # noqa: E402
from tpuddp import config as cfg  # noqa: E402
from tpuddp.training import loop  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("hooks", nargs="+", choices=("none", "bf16", "bf16_ef", "int8_ef", "topk_ef"))
    parser.add_argument("--epochs", type=int, default=1)
    args = parser.parse_args(argv)
    print(f"jax {jax.__version__} on {jax.devices()}", flush=True)
    for hook in args.hooks:
        training = dict(
            cfg.TRAINING_DEFAULTS, model="alexnet", dataset="synthetic", synthetic_n=(2048, 512),
            train_batch_size=128, test_batch_size=100, learning_rate=1e-3, image_size=224, seed=0,
            num_epochs=args.epochs, checkpoint_epoch=args.epochs + 1, scan_steps=1, comm_hook=hook,
        )
        rows = []
        real = loop.run_training_loop

        def recording(*a, **kw):
            state, history = real(*a, **kw)
            rows.extend(history)
            return state, history

        train_native.run_training_loop = recording
        try:
            train_native.basic_ddp_training_loop(0, 1, None, {"set_epoch": True}, training=training)
        finally:
            train_native.run_training_loop = real
        print(json.dumps({"hook": hook, "epochs": [
            {"train_loss": r["train_loss"], "test_loss": r["test_loss"]} for r in rows]}), flush=True)


if __name__ == "__main__":
    main()
