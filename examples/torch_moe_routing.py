"""The paper's technique in its framework role, on the PyTorch/CUDA port:
sort-based MoE dispatch, the reference's ``examples/moe_routing.py``
through ``repro_torch``.

Runs the deepseek-moe-16b family (reduced config) and shows the IPS4o
partition machinery routing tokens to experts:

  * expert-major token grouping through ``ops.group_by``, the stable
    partition and the dispatch-rank kernel (K6) agreeing,
  * per-layer routing in one call: a whole step's routing ids (L, n*k)
    dispatched by one batched ``sort_dispatch`` (K6's batched form on the
    card) and ordered by one ``batched_argsort``,
  * per-expert token counts, capacity clamping and the drop fraction,
  * gradient flow through the dispatch (a few training steps on a copy
    task: the loss drops).

  PYTHONPATH=src python examples/torch_moe_routing.py [--device cpu]

Runs on the card by default; ``--device cpu`` runs the plain twins.
"""
import argparse

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    dev = torch.device(args.device)

    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.moe import expert_capacity, sort_dispatch
    from repro_torch.models.transformer import init_model, param_leaves, train_loss
    from repro_torch.ops import batched_argsort, group_by
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    # --- 1. dispatch mechanics on raw routing ids --------------------------
    E, k, n = 8, 2, 4096
    rng = np.random.default_rng(0)
    flat_e = torch.as_tensor(rng.integers(0, E, n * k).astype(np.int32), device=dev)
    cap = expert_capacity(n, E, k, 1.25)
    slot, kept, counts = sort_dispatch(flat_e, E, cap)
    print(f"experts={E} top_k={k} tokens={n} capacity={cap}")
    print(f"per-expert counts: {counts.tolist()}")
    print(f"dropped: {1 - float(kept.sum()) / (n * k):.4%}")
    assert len(torch.unique(slot[kept])) == int(kept.sum())

    # --- 1b. the same grouping as a library call ---------------------------
    # group_by IS the dispatch problem: group (token, k) entries expert-major
    tok_idx = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(k)
    g = group_by(flat_e, tok_idx, num_groups=E, device=dev)                    # stable partition
    gp = group_by(flat_e, tok_idx, num_groups=E, method="pallas", device=dev)  # K6
    assert torch.equal(g.counts, counts)
    assert torch.equal(g.keys, gp.keys) and torch.equal(g.perm, gp.perm)
    assert bool((torch.diff(g.keys) >= 0).all())  # expert-major grouping
    print(f"ops.group_by == dispatch-rank grouping (max per-expert load "
          f"{int(g.counts.max())})")

    # --- 1c. per-layer routing in one call ---------------------------------
    L = 6
    flat_e_layers = torch.as_tensor(rng.integers(0, E, (L, n * k)).astype(np.int32),
                                    device=dev)
    slot_b, kept_b, counts_b = sort_dispatch(flat_e_layers, E, cap)
    for layer in range(L):
        s1, k1, c1 = sort_dispatch(flat_e_layers[layer], E, cap)
        assert torch.equal(slot_b[layer], s1) and torch.equal(kept_b[layer], k1)
        assert torch.equal(counts_b[layer], c1)
    # the expert-major order itself, for all layers in one batched argsort
    order_b = batched_argsort(flat_e_layers, device=dev)
    grouped = torch.gather(flat_e_layers, 1, order_b.to(torch.int64))
    assert bool((torch.diff(grouped, dim=1) >= 0).all())
    print(f"1c. {L} layers routed in one batched call (per-layer == unbatched, bit-exact)")

    # --- 2. the same machinery inside the full model -----------------------
    cfg = get_reduced("deepseek-moe-16b")
    model = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    model.requires_grad_(True)
    leaves = param_leaves(model)
    flat = [t for v in leaves.values() for t in (v if isinstance(v, tuple) else (v,))]
    opt = adamw_init(leaves, AdamWConfig())
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)

    def step(batch):
        loss, metrics = train_loss(model, cfg, batch, lb_coef=0.01)
        gs = iter(torch.autograd.grad(loss, flat))
        grads = {name: tuple(next(gs) for _ in v) if isinstance(v, tuple) else next(gs)
                 for name, v in leaves.items()}
        adamw_update(leaves, grads, opt, AdamWConfig(lr=1e-3), 1.0)
        return loss.detach(), {key: v.detach() for key, v in metrics.items()}

    losses = []
    for i, batch in zip(range(args.steps), iter(data)):
        batch = {key: torch.as_tensor(v, device=dev) for key, v in batch.items()}
        # learnable task (copy): next-token = current token
        batch["labels"] = batch["inputs"]
        loss, metrics = step(batch)
        losses.append(float(loss))
        if i % 5 == 0:
            extra = {key: round(float(v), 4) for key, v in metrics.items()}
            print(f"step {i}: loss={losses[-1]:.4f} {extra}")

    assert losses[-1] < losses[0], f"loss did not drop: {losses[0]} -> {losses[-1]}"
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} through the sort-based dispatch "
          "(gradients flow) — OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
