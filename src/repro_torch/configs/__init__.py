from repro_torch.configs.base import (
    ArchConfig, Block, MoEConfig, SSMConfig, ShapeCell,
    SHAPE_CELLS, SHAPES_BY_NAME, LONG_CONTEXT_OK, cells_for,
)
from repro_torch.configs.registry import ARCHS, get_arch

__all__ = [
    "ArchConfig", "Block", "MoEConfig", "SSMConfig", "ShapeCell",
    "SHAPE_CELLS", "SHAPES_BY_NAME", "LONG_CONTEXT_OK", "cells_for",
    "ARCHS", "get_arch",
]
