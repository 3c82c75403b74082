"""Production mesh construction.

Counterpart of ``repro.launch.mesh``.  ``make_production_mesh`` builds a
``DeviceMesh`` over the process group that exists (``torchrun``'s ranks,
or the dry run's fake group): ``(16, 16)`` with axes ``("data", "model")``,
or ``(2, 16, 16)`` with ``("pod", "data", "model")``.  It is a function,
not a module-level constant, so importing this module touches no process
group.

``fake_group`` starts and stops torch's ``fake`` process-group backend of
256 or 512 ranks, on which the dry run builds the production mesh and runs
a step on fake tensors with nothing allocated and nothing sent.  The group
is global to its process: run it in a child process of its own, never
inside a test worker.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, Tuple

__all__ = ["make_production_mesh", "dp_axes", "tp_axis", "axis_sizes", "fake_group",
           "production_shape"]


def production_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production ``DeviceMesh`` over the default process group, whose
    world size must be the mesh's 256 or 512 ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of any object with
    ``mesh_dim_names`` and ``shape``, such as a stand-in with no ranks)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel axes: batch (and FSDP/ZeRO param+state sharding)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"


@contextmanager
def fake_group(world_size: int) -> Iterator[None]:
    """The ``fake`` process group of ``world_size`` ranks (this process is
    rank 0) for the duration of the block: collectives return at once with
    their outputs' shapes and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_group: a process group already exists in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
