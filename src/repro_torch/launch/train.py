"""End-to-end training launcher, on one card or over several.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --reduced \
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]

Counterpart of ``repro.launch.train`` with its flags, plus ``--device``
(the card by default; ``cpu`` runs the kernels' plain twins).  Over the
ranks ``torchrun`` starts (its ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
and ``MASTER_PORT``; NCCL on the card, gloo on the CPU) it trains, as the
reference does, over a ``(ranks, 1)`` mesh with axes ("data", "model"),
each rank checkpointing its own shards:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch yi-9b --reduced

One process alone takes the one-device step, which the reference's
``(1, 1)`` mesh amounts to, without DTensor's host work.
Demonstrates the data pipeline, seeded init,
the step with accumulation, checkpoint/restart (kill it mid-run and launch
it again: it resumes from the newest complete checkpoint and fast-forwards
the data stream) and the straggler ledger's log.
"""
import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    tcfg = TrainConfig(
        microbatch=args.microbatch,
        warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps,
        compress_grads=args.compress_grads,
        adamw=AdamWConfig(lr=args.lr),
    )
    data = SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, embed_dim=cfg.d_model if cfg.takes_embeds else 0,
    )

    import os

    mesh = _mesh(args.device) if int(os.environ.get("WORLD_SIZE", "1")) > 1 else None
    trainer = Trainer(cfg, tcfg, mesh=mesh, ckpt_dir=args.ckpt_dir, seed=args.seed,
                      device=args.device)
    trainer.init_state()
    if trainer.maybe_restore():
        print(f"resumed from step {trainer.step_num}")
    it = iter(data)
    # fast-forward the data stream for a bitwise-identical resume
    for _ in range(trainer.step_num):
        next(it)
    metrics = trainer.run(it, args.steps - trainer.step_num, ckpt_every=args.ckpt_every)
    print("final:", metrics)
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def _mesh(device: str):
    """The reference's (ranks, 1) mesh over torchrun's ranks."""
    import os

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.ops.sort import _device

    dev = _device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    world = int(os.environ["WORLD_SIZE"])
    return init_device_mesh(dev.type, (world, 1), mesh_dim_names=("data", "model"))


if __name__ == "__main__":
    sys.exit(main())
