from .adamw import (AdamWState, adamw_init, adamw_update, cosine_schedule,
                    global_norm_clip)
from .compress import (compressed_psum, dequantize_int8, quantize_int8)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm_clip", "quantize_int8", "dequantize_int8",
           "compressed_psum"]
