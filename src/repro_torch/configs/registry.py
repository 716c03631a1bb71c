"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, SHAPE_CELLS, SHAPES_BY_NAME, cells_for

from repro_torch.configs.phi_3_vision_4_2b import CONFIG as _phi3v
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _jamba
from repro_torch.configs.qwen2_7b import CONFIG as _qwen2
from repro_torch.configs.gemma2_27b import CONFIG as _gemma2
from repro_torch.configs.h2o_danube_3_4b import CONFIG as _danube
from repro_torch.configs.nemotron_4_15b import CONFIG as _nemotron
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        _phi3v, _jamba, _qwen2, _gemma2, _danube,
        _nemotron, _seamless, _mamba2, _mixtral, _moonshot,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "get_arch", "ArchConfig", "SHAPE_CELLS", "SHAPES_BY_NAME", "cells_for"]
