# Copied from src/repro/configs/graphsage_reddit.py; keep the two in step.
"""graphsage-reddit [gnn]: 2 layers d128 mean aggregator, fanout 25-10
[arXiv:1706.02216]."""
from ..models.gnn import GNNConfig
from .api import ArchSpec, gnn_shapes

SPEC = ArchSpec(
    arch_id="graphsage-reddit", family="gnn",
    model_cfg=GNNConfig(name="graphsage-reddit", arch="graphsage",
                        n_layers=2, d_hidden=128, d_feat=602,
                        n_classes=41, aggregator="mean"),
    shapes=gnn_shapes())
