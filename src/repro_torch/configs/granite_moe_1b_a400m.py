# Copied from src/repro/configs/granite_moe_1b_a400m.py (jnp dtypes as torch dtypes); keep the two in step.
"""granite-moe-1b-a400m [moe]: 24L d1024 16H (GQA kv=8) ff512/expert
vocab 49155, MoE 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m]."""
import torch
from ..models.transformer import LMConfig
from .api import ArchSpec, lm_shapes

SPEC = ArchSpec(
    arch_id="granite-moe-1b-a400m", family="lm",
    model_cfg=LMConfig(name="granite-moe-1b-a400m", n_layers=24,
                       d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
                       vocab=49155, moe=True, n_experts=32, top_k=8,
                       rope_theta=10_000.0, dtype=torch.bfloat16,
                       attn_chunk=1024),
    shapes=lm_shapes(), seqs_per_micro=2,
    notes="32 experts / 16 ranks = 2 experts per rank; vocab 49155 is "
          "padded to 49408 (multiple of 256) for the TP vocab shard.")
