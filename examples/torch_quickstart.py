"""Quickstart of the PyTorch/CUDA port: the IPS4o sorting library in seven
snippets, the reference's ``examples/quickstart.py`` through ``repro_torch``.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the card by default; ``--device cpu`` runs the kernels' plain twins.
"""
import argparse
import os
import tempfile

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    dev = torch.device(args.device)

    from repro_torch import dist, ops, stream
    from repro_torch.core.ips4o import make_sorter

    # 1. Sort keys ---------------------------------------------------------
    x = torch.as_tensor(np.random.default_rng(0).random(1 << 17, dtype=np.float32), device=dev)
    y = ops.sort(x, device=dev)
    assert bool((y[:-1] <= y[1:]).all())
    print(f"1. sorted {x.shape[0]} f32 keys: head={y[:4].tolist()}")

    # 2. Key + payload (any pytree of tensors with a matching leading dim) --
    payload = {"idx": torch.arange(x.shape[0], device=dev),
               "vec": torch.zeros((x.shape[0], 3), device=dev)}
    yk, yv = ops.sort(x, payload, device=dev)
    assert torch.equal(x[yv["idx"]], yk)
    print("2. payload rows follow their keys (checked)")

    # 3. In place: the sorted keys written back into the caller's tensor ---
    sorter = make_sorter(x.shape[0], x.dtype, donate=True)
    buf = x.clone()
    assert sorter(buf) is buf and torch.equal(buf, y)
    print("3. donating sorter: the sorted keys are back in the caller's tensor")

    # 4. Duplicate-heavy input -> equality buckets (paper §4.4) -------------
    dup = torch.as_tensor((np.arange(1 << 17) % 317).astype(np.float32), device=dev)
    yd = ops.sort(dup, device=dev)
    assert bool((yd[:-1] <= yd[1:]).all())
    print("4. RootDup-style input sorted via equality buckets")

    # 5. Distributed sort on a one-rank process group (NCCL on the card, gloo
    #    on the CPU); every rank of a larger group calls it with its shard --
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    with tempfile.TemporaryDirectory() as tmp:
        tdist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                 init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                                 rank=0, world_size=1)
        try:
            mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("data",))
            out, counts, overflow = dist.sort(x, mesh, "data")
            assert not bool(overflow.any()) and torch.equal(out[:int(counts[0])], y)
            print(f"5. distributed sort: {int(counts.sum())} elements globally ordered "
                  f"across {mesh.size()} rank(s)")
        finally:
            tdist.destroy_process_group()

    # 6. Batched: (B, n) rows sorted in one call (no Python loop) ----------
    xb = torch.as_tensor(np.random.default_rng(1).random((8, 1 << 14), np.float32), device=dev)
    yb = ops.batched_sort(xb, device=dev)
    assert bool((yb[:, :-1] <= yb[:, 1:]).all())
    vals, idx = ops.batched_topk(xb, 4, device=dev)
    assert torch.equal(vals[:, 0], xb.max(dim=1).values)
    print(f"6. batched: {xb.shape[0]} rows x {xb.shape[1]} keys sorted in one call; "
          "per-row top-4 via batched_topk")

    # 7. Streaming / out of core: run formation + a stable k-way merge ------
    host = np.random.default_rng(2).standard_normal(1 << 16).astype(np.float32)
    ys = stream.external_sort(host, chunk_size=1 << 14, device=dev)  # 4 chunks
    assert (ys[:-1] <= ys[1:]).all()
    h = torch.as_tensor(host, device=dev)
    m = stream.merge([torch.sort(h[:1 << 13]).values, torch.sort(h[1 << 13:1 << 14]).values])
    assert bool((m[:-1] <= m[1:]).all())
    tv, ti = stream.streaming_topk(host, 8, chunk_size=1 << 14, device=dev)
    assert tv[0] == host.max()
    print(f"7. streaming: {host.shape[0]} host-resident keys external-sorted in chunks; "
          "k-way merge + streaming top-8 (indices into the stream)")
    print("quickstart OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
