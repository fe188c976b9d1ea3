# Copied from src/repro/configs/granite_8b.py (jnp dtypes as torch dtypes); keep the two in step.
"""granite-8b [dense]: 36L d4096 32H (GQA kv=8) ff14336 vocab 49152.
Llama-arch code model [arXiv:2405.04324]."""
import torch
from ..models.transformer import LMConfig
from .api import ArchSpec, lm_shapes

SPEC = ArchSpec(
    arch_id="granite-8b", family="lm",
    model_cfg=LMConfig(name="granite-8b", n_layers=36, d_model=4096,
                       n_heads=32, n_kv_heads=8, d_ff=14336, vocab=49152,
                       rope_theta=10_000_000.0, dtype=torch.bfloat16,
                       attn_chunk=1024, zero_stage=1,
                       remat_policy="save_tp_outputs"),
    shapes=lm_shapes(), seqs_per_micro=1,
    notes="heads 32 %% 16 == 0 -> TP on heads. ZeRO-1: bf16 params "
          "(1 GB/dev at tp=16) replicate over data, opt state sharded "
          "— kills the per-layer FSDP all-gathers (EXPERIMENTS §Perf "
          "P1); save_tp_outputs remat keeps the per-layer all-reduced "
          "tensors so the recompute pass skips their collectives (P1b).")
