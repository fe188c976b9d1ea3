# Copied from src/repro/data/roads.py (numpy only); keep the two in step.
# One deliberate difference: road64k closes its overlay densely here.
"""Named road-graph presets for the serve/benchmark drivers.

One registry for every graph size the drivers, benchmarks, CI smokes,
and BENCH records refer to by name, so "road64k" means the same
(nodes, seed, overlay hierarchy) everywhere.  ``road_like`` keeps the
largest connected component, so the realized node count lands slightly
under ``nodes`` — names are nominal, records carry the name.

The ``hierarchy`` field is the overlay-closure knob threaded into
``build_device_index`` (DESIGN.md §12): road4000 pins the dense
closure explicitly (its records must stay comparable with the whole
pre-hierarchy BENCH history — and "auto" picks dense at that size
anyway); road64k pins the measured sweet spot of three levels so the
CI smoke and BENCH records can't drift with the auto heuristics;
road250k rides "auto", which keeps adding grouping levels until the
top boundary fits under the dense threshold or stops shrinking
(DESIGN.md §13).

The port has no overlay hierarchy yet, so its road64k preset pins the
dense closure (``hierarchy=1``): the largest preset whose overlay
(S ~ 4.6k) still closes as one dense witness Floyd-Warshall on one
card.  Presets that resolve to more than one level are refused by the
device build until the hierarchy is ported.
"""
from __future__ import annotations

import dataclasses

from ..core.graph import Graph, road_like


@dataclasses.dataclass(frozen=True)
class RoadPreset:
    name: str
    nodes: int
    seed: int = 0
    hierarchy: int | str = "auto"

    def make(self, seed: int | None = None) -> Graph:
        return road_like(self.nodes,
                         seed=self.seed if seed is None else seed)


ROAD_PRESETS = {
    p.name: p for p in (
        RoadPreset("road2000", nodes=2000, hierarchy=1),
        RoadPreset("road4000", nodes=4000, hierarchy=1),
        RoadPreset("road16k", nodes=16_000),
        RoadPreset("road64k", nodes=64_000, hierarchy=1),
        RoadPreset("road250k", nodes=250_000),
    )
}


def road_preset(name: str) -> RoadPreset:
    """Preset by name, with a helpful error listing what exists."""
    try:
        return ROAD_PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown road preset {name!r}; have "
            f"{sorted(ROAD_PRESETS)}") from None
