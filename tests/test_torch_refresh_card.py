"""A refresh epoch on the card against the same refresh on the CPU.

No JAX here (the card's machine has none): one ``refresh_index`` epoch
of ``road_like(900)`` with 96 hub nodes, built and refreshed on the card
(the CUDA kernels), equals the same build and refresh on the CPU (the
plain versions), table for table and sidecar for sidecar, at hierarchy
levels 1 and 3; an ``EpochedEngine`` given no device builds, refreshes
and serves on the card.  Skips without a card; on one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_refresh_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import device_engine as tde
from repro_torch.core import dijkstra
from repro_torch.core.dist_engine import EpochedEngine
from repro_torch.core.graph import road_like, traffic_updates
from repro_torch.core.supergraph import build_index
from repro_torch.kernels import floyd_warshall


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lv", [1, 3])
def test_refresh_on_card_equals_cpu(cuda_device, lv):
    """One refreshed epoch on the card (the CUDA kernels) == the same
    refresh on the CPU (the plain versions), table for table."""
    g = road_like(900, seed=0)
    hubs = np.random.default_rng(7).choice(g.n, 96, replace=False)
    ix = build_index(g)
    u, v, w = traffic_updates(g, 0.03, seed=4)
    g2 = g.with_edge_weights(u, v, w)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        dix, plan = tde.build_device_index_with_plan(
            ix, device=dev, hierarchy_levels=lv, hub_nodes=hubs)
        before = floyd_warshall.fw_next_blocked_cuda.launches
        out[dev.type] = tde.refresh_index(dix, plan, g2, u, v, w)
        if dev.type == "cuda":
            assert floyd_warshall.fw_next_blocked_cuda.launches > before
    (card, card_st), (cpu, cpu_st) = out["cuda"], out["cpu"]
    assert card.device.type == "cuda"
    names = list(tde.FIELD_DTYPES) + list(tde.TUPLE_FIELD_DTYPES)
    eq = tde.index_fields_equal(card, cpu, names)
    assert all(eq.values()), [k for k, ok in eq.items() if not ok]
    assert all(tde.sidecars_equal(card, cpu).values())
    assert card_st.top_closure == cpu_st.top_closure


@pytest.mark.cuda
def test_epoched_engine_defaults_to_the_card(cuda_device):
    g = road_like(420, seed=41)
    eng = EpochedEngine(g, hierarchy_levels=2)
    assert eng.dix.device.type == "cuda"
    eng.apply_updates(*traffic_updates(g, 0.05, seed=3))
    rng = np.random.default_rng(1)
    s, t = rng.integers(0, g.n, 64), rng.integers(0, g.n, 64)
    want = np.array([dijkstra.pair(eng.g, int(a), int(b))
                     for a, b in zip(s, t)], np.float32)
    np.testing.assert_array_equal(eng.query(s, t), want)
