# Copied from src/repro/configs/dimenet.py; keep the two in step.
"""dimenet [gnn]: 6 interaction blocks, d128, 8 bilinear, 7 spherical x
6 radial bases; triplet directional message passing [arXiv:2003.03123].
Triplet count is capped at 2 x n_edges (GemNet-style angular sampling) —
recorded in DESIGN.md §Arch-applicability."""
from ..models.gnn import GNNConfig
from .api import ArchSpec, gnn_shapes

SPEC = ArchSpec(
    arch_id="dimenet", family="gnn",
    model_cfg=GNNConfig(name="dimenet", arch="dimenet", n_layers=6,
                        d_hidden=128, d_feat=32, n_bilinear=8,
                        n_spherical=7, n_radial=6, n_out=1),
    shapes=gnn_shapes())
