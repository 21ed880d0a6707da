"""End-to-end training on the port: a ~100M-class qwen2-family model, a
few hundred steps on the synthetic corpus, with checkpoints — the twin of
the reference's ``examples/train_100m.py``.

The config is the qwen2-0.5b architecture scaled down (6 layers, d 512,
vocab 32000), registered as ``qwen2-100m`` in the port's ``ARCHS``.  On
the repeated-n-gram corpus the loss must end more than 0.5 below where
it started after 100 steps or more, which proves that the whole stack
(data → model → optimizer → checkpoint) learns.

Run: PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 300]
     [--cpu] [--ckpt-dir DIR]   (on the card unless --cpu; checkpoints in
     a fresh temporary directory unless --ckpt-dir)
"""

import argparse
import dataclasses
import tempfile

from repro_torch.configs import ARCHS
from repro_torch.launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one, removed at the end)")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of the card")
    args = ap.parse_args(argv)

    ARCHS["qwen2-100m"] = dataclasses.replace(
        ARCHS["qwen2-0.5b"], name="qwen2-100m", n_layers=6, d_model=512,
        n_heads=8, n_kv_heads=2, head_dim=64, d_ff=2048, vocab=32000,
        remat=False)
    with tempfile.TemporaryDirectory(prefix="train_100m_") as tmp:
        out = train(
            arch="qwen2-100m", steps=args.steps, smoke=False,
            seq_len=128, global_batch=8,
            ckpt_dir=args.ckpt_dir or tmp, ckpt_every=100,
            grad_compression=True, log_every=10,
            device="cpu" if args.cpu else None,
        )
    losses = out["losses"]
    print(f"loss: start {losses[0]:.3f} → end {losses[-1]:.3f}")
    if args.steps >= 100:
        if not losses[-1] < losses[0] - 0.5:
            raise AssertionError("model failed to learn")
        print("OK: end-to-end training learns on this stack")
    return out


if __name__ == "__main__":
    main()
