"""End-to-end training with the PyTorch/CUDA port: train a reduced-config
LM for a few hundred steps on the synthetic pipeline, with
checkpoint/restart, the reference's ``examples/train_lm.py`` through
``repro_torch``.

  PYTHONPATH=src python examples/torch_train_lm.py                 # yi-9b reduced, 120 steps
  PYTHONPATH=src python examples/torch_train_lm.py --arch deepseek-moe-16b --steps 60
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu    # the plain twins

A thin preset over the launcher (``python -m repro_torch.launch.train``),
on the card by default.  Kill it mid-run and launch the launcher again
with the same ``--ckpt-dir`` to see the restart.
"""
import argparse
import sys
import tempfile


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()

    from repro_torch.launch.train import main as train_main

    with tempfile.TemporaryDirectory() as ckpt:
        rc = train_main([
            "--arch", args.arch, "--reduced",
            "--steps", str(args.steps),
            "--batch", str(args.batch),
            "--seq", str(args.seq),
            "--microbatch", str(max(args.batch // 2, 1)),
            "--ckpt-dir", ckpt,
            "--ckpt-every", str(max(args.steps // 2, 1)),
            "--device", args.device,
        ])
    return rc


if __name__ == "__main__":
    sys.exit(main())
