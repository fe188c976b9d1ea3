# Copied from src/repro/configs/__init__.py; keep the two in step.
"""Architecture registry: --arch <id> resolves here."""
from __future__ import annotations

from . import (command_r_plus_104b, dimenet, gat_cora, granite_8b,
               granite_moe_1b_a400m, graphcast, graphsage_reddit,
               llama4_scout_17b_a16e, phi4_mini_3_8b, wide_deep)
from .api import ArchSpec, ShapeCell

_ALL = [granite_8b.SPEC, command_r_plus_104b.SPEC, phi4_mini_3_8b.SPEC,
        llama4_scout_17b_a16e.SPEC, granite_moe_1b_a400m.SPEC,
        graphcast.SPEC, dimenet.SPEC, graphsage_reddit.SPEC,
        gat_cora.SPEC, wide_deep.SPEC]

REGISTRY = {s.arch_id: s for s in _ALL}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id}; have {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def list_archs():
    return sorted(REGISTRY)
