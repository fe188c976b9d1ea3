# Copied from src/repro/configs/gat_cora.py; keep the two in step.
"""gat-cora [gnn]: 2 layers, 8 heads x d8, attention aggregator
[arXiv:1710.10903]."""
from ..models.gnn import GNNConfig
from .api import ArchSpec, gnn_shapes

SPEC = ArchSpec(
    arch_id="gat-cora", family="gnn",
    model_cfg=GNNConfig(name="gat-cora", arch="gat", n_layers=2,
                        d_hidden=8, n_heads=8, d_feat=1433, n_classes=7,
                        aggregator="attn"),
    shapes=gnn_shapes())
