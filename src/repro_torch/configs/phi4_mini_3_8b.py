# Copied from src/repro/configs/phi4_mini_3_8b.py (jnp dtypes as torch dtypes); keep the two in step.
"""phi4-mini-3.8b [dense]: 32L d3072 24H (GQA kv=8) ff8192 vocab 200064.
RoPE SwiGLU GQA [arXiv:2412.08905]."""
import torch
from ..models.transformer import LMConfig
from .api import ArchSpec, lm_shapes

SPEC = ArchSpec(
    arch_id="phi4-mini-3.8b", family="lm",
    model_cfg=LMConfig(name="phi4-mini-3.8b", n_layers=32, d_model=3072,
                       n_heads=24, n_kv_heads=8, d_ff=8192, vocab=200064,
                       rope_theta=10_000.0, dtype=torch.bfloat16,
                       attn_chunk=128),
    shapes=lm_shapes(), seqs_per_micro=4,
    notes="24 heads %% 16 != 0 -> attention replicated over model axis "
          "(FFN/vocab still TP); smaller attn_chunk bounds score tiles.")
