"""Model configurations: the schema (``base``), the ten assigned
architectures (data only) and their registry, copied from
``repro.configs`` so that the port imports nothing of ``repro``."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, reduced
from repro_torch.configs.registry import (
    ARCHS, SHAPES, Shape, cells, get_config, get_reduced, input_specs, shape_applicable,
)

__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "reduced", "ARCHS", "get_config", "get_reduced",
    "SHAPES", "Shape", "cells", "input_specs", "shape_applicable",
]
