# Copied from src/repro/configs/graphcast.py; keep the two in step.
"""graphcast [gnn]: 16-layer encoder-processor-decoder mesh GNN,
d_hidden 512, sum aggregation, 227 vars [arXiv:2212.12794]."""
from ..models.gnn import GNNConfig
from .api import ArchSpec, gnn_shapes

SPEC = ArchSpec(
    arch_id="graphcast", family="gnn",
    model_cfg=GNNConfig(name="graphcast", arch="graphcast", n_layers=16,
                        d_hidden=512, d_feat=227, n_out=227,
                        aggregator="sum"),
    shapes=gnn_shapes(),
    notes="mesh_refinement=6 maps to the mesh graph the shape provides; "
          "n_vars=227 is the node-feature/output width.  Per-shape "
          "d_feat overrides n_vars where the shape pins it.")
