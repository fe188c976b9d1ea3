# Copied from src/repro/configs/wide_deep.py; keep the two in step.
"""wide-deep [recsys]: 40 sparse fields x 1M rows x dim32 tables,
MLP 1024-512-256, concat interaction [arXiv:1606.07792]."""
from ..models.recsys import RecsysConfig
from .api import ArchSpec, recsys_shapes

SPEC = ArchSpec(
    arch_id="wide-deep", family="recsys",
    model_cfg=RecsysConfig(name="wide-deep", n_sparse=40, n_dense=13,
                           embed_dim=32, rows_per_field=1_000_000,
                           hots_per_field=2, mlp_dims=(1024, 512, 256),
                           interaction="concat"),
    shapes=recsys_shapes(),
    notes="embedding tables row-sharded on model axis; EmbeddingBag = "
          "take + segment_sum (no native op in JAX).")
