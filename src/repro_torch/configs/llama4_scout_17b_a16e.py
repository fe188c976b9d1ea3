# Copied from src/repro/configs/llama4_scout_17b_a16e.py (jnp dtypes as torch dtypes); keep the two in step.
"""llama4-scout-17b-a16e [moe]: 48L d5120 40H (GQA kv=8) ff8192
vocab 202048, MoE 16 experts top-1 [hf:meta-llama/Llama-4-Scout-17B-16E]."""
import torch
from ..models.transformer import LMConfig
from .api import ArchSpec, lm_shapes

SPEC = ArchSpec(
    arch_id="llama4-scout-17b-a16e", family="lm",
    model_cfg=LMConfig(name="llama4-scout-17b-a16e", n_layers=48,
                       d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
                       vocab=202048, moe=True, n_experts=16, top_k=1,
                       rope_theta=500_000.0, dtype=torch.bfloat16,
                       attn_chunk=128, gather_fsdp_in_body=True,
                       seq_shard_activations=True),
    shapes=lm_shapes(), seqs_per_micro=1,
    opt_state_dtype="bfloat16", serialize_opt_update=True,
    grad_accum_dtype="bfloat16",
    notes="EP: 16 experts == model axis -> 1 expert/rank; 40 heads not "
          "divisible by 16 -> attention replicated over model.")
