# Copied from src/repro/configs/command_r_plus_104b.py (jnp dtypes as torch dtypes); keep the two in step.
"""command-r-plus-104b [dense]: 64L d12288 96H (GQA kv=8) ff33792
vocab 256000, no biases [hf:CohereForAI/c4ai-command-r-v01]."""
import torch
from ..models.transformer import LMConfig
from .api import ArchSpec, lm_shapes

SPEC = ArchSpec(
    arch_id="command-r-plus-104b", family="lm",
    model_cfg=LMConfig(name="command-r-plus-104b", n_layers=64,
                       d_model=12288, n_heads=96, n_kv_heads=8,
                       d_ff=33792, vocab=256000, rope_theta=75_000_000.0,
                       dtype=torch.bfloat16, attn_chunk=1024,
                       gather_fsdp_in_body=True,
                       seq_shard_activations=True),
    shapes=lm_shapes(), seqs_per_micro=1,
    opt_state_dtype="bfloat16", serialize_opt_update=True,
    grad_accum_dtype="bfloat16",
    notes="104B dense: ZeRO-3 FSDP on data + TP on model is mandatory "
          "for 16 GB chips; 1 seq/device per microbatch.")
