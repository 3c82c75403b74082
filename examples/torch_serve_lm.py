"""Batched serving with the PyTorch/CUDA port: the scheduler admits a wave
by remaining length, then the engine prefills and decodes (through the
K10 kernel on the card), the reference's ``examples/serve_lm.py`` through
``repro_torch``.

  PYTHONPATH=src python examples/torch_serve_lm.py [--arch yi-9b] [--new 24] [--device cpu]

``--arch`` takes any architecture the port serves from tokens (the dense,
moe, ssm and hybrid families: e.g. yi-9b, deepseek-moe-16b, rwkv6-1.6b,
zamba2-2.7b), at the reduced size of ``configs.get_reduced``.  Runs on the
card by default; ``--device cpu`` runs the plain twins.  Shows:

  * the scheduler ordering requests by remaining length (the sorting
    engine's serving role), FIFO among ties;
  * greedy generation determinism: the same prompts twice on one engine,
    and on a fresh engine, give the same tokens.
"""
import argparse

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    dev = torch.device(args.device)

    from repro_torch.configs import get_reduced
    from repro_torch.models.policy import compute_policy
    from repro_torch.models.transformer import init_model
    from repro_torch.serve import Engine, Request, Scheduler, ServeConfig

    cfg = get_reduced(args.arch)
    if cfg.takes_embeds:
        raise SystemExit(f"{args.arch} takes embeddings, not tokens: pick a token model")
    model = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)

    # scheduler: admit a ragged queue, batch by sorted remaining length
    rng = np.random.default_rng(0)
    sched = Scheduler(batch_size=args.batch, device=dev)
    lens = {}
    for i in range(args.batch * 2):
        plen = int(rng.integers(4, args.prompt_len + 1))
        lens[i] = plen
        sched.submit(Request(uid=i, prompt_len=plen, max_new=int(rng.integers(8, args.new + 1))))
    wave = sched.next_batch()
    print(f"scheduler picked {len(wave)} of {args.batch * 2} requests "
          f"(remaining {[r.remaining for r in wave]}: sorted, least pad waste)")

    scfg = ServeConfig(max_seq=args.prompt_len + args.new + 8, batch_size=args.batch)
    engine = Engine(cfg, scfg, model, device=dev)
    prompts = np.zeros((args.batch, args.prompt_len), np.int32)
    for r_i, r in enumerate(wave[:args.batch]):
        plen = lens[r.uid]
        prompts[r_i, -plen:] = rng.integers(0, cfg.vocab_size, plen)

    with compute_policy(flash_decode=True):
        out1 = engine.generate(prompts, args.new)
        print(f"generated {tuple(out1.shape)} tokens; first row: {out1[0, :8].tolist()}...")
        # greedy determinism: the same engine back to back (its cache starts
        # afresh each call), then a fresh engine
        out2 = engine.generate(prompts, args.new)
        out3 = Engine(cfg, scfg, model, device=dev).generate(prompts, args.new)
    assert torch.equal(out1, out2) and torch.equal(out1, out3)
    print("greedy decode deterministic across calls and engine instances: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
