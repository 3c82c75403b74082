"""repro_torch — the PyTorch/CUDA port of ``repro`` (IPS4o) for one NVIDIA H100.

It mirrors ``repro``'s layout and names, imports ``torch`` and numpy and
never ``jax`` or ``repro``, and runs its hand-written CUDA kernels
(``repro_torch.kernels``) on the card.  This slice ports the 1-D
``ops.sort``/``ops.argsort`` main path for float32 and int32 keys with the
default ``SortConfig`` and the tree classifier; ROADMAP.md lists what is
still to be ported.
"""
