"""repro_torch.kernels — the port's hand-written CUDA kernels for Hopper.

| kernel | wrapper | source | replaces |
| --- | --- | --- | --- |
| K1 | ``level_fused.level_fused`` | ``csrc/level_fused.cu`` | ``repro/kernels/level_fused.py:160`` |
| K2 | ``level_fused.rank_hist`` | ``csrc/level_fused.cu`` | ``repro/kernels/level_fused.py:311`` |
| K3 | ``bitonic.sort_windows`` | ``csrc/bitonic.cu`` | ``repro/kernels/bitonic.py:72`` |

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs its
plain torch twin only on a CPU tensor.  The kernels are built with ``nvcc``
on first use (``_build``); importing this package builds nothing.
"""
from typing import Dict

from repro_torch.kernels._build import LAUNCHES, build_all

__all__ = ["launch_counts", "reset_launch_counts", "build_all"]


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
