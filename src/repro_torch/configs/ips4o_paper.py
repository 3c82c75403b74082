"""The paper's own tuning parameters (§4.7) and the sort presets.

Counterpart of ``repro.configs.ips4o_paper``, with the port's
``SortConfig``.

Paper (x86 multicore, C++):
    k = 256 buckets, alpha = 0.2 log n oversampling, beta = 1
    overpartitioning, base case n0 = 16 (insertion sort), block size
    b = max(1, 2^(11 - log2 s)) elements (~2 KiB).

The presets keep the reference's names and values: ``TPU_DEFAULT`` is the
``SortConfig`` defaults (W = 8192, kmax = 128, tile 4096), and
``TPU_BIG_PAYLOAD`` takes fewer, larger buckets per level for large
payloads (the paper's §6 caveat for Quartet and 100Bytes): W = 16384,
kmax = 64, tile 8192, which K3 and the 64-bit K1 take on the card.
"""
from __future__ import annotations

from repro_torch.core.ips4o import SortConfig

__all__ = ["PAPER_CPU", "TPU_DEFAULT", "TPU_BIG_PAYLOAD"]

# The paper's values, recorded for reference.
PAPER_CPU = {
    "k": 256,
    "alpha": "0.2 * log2(n)",
    "beta": 1,
    "n0": 16,
    "block_bytes": 2048,
}

TPU_DEFAULT = SortConfig()

TPU_BIG_PAYLOAD = SortConfig(base_case=16384, kmax=64, tile=8192)
