from .adamw import AdamW, AdamWState
from .grad import (ErrorFeedback, accumulate_grads, clip_by_global_norm,
                   compress_bf16, global_norm, value_and_grad)
from .schedule import linear_warmup_cosine, make_schedule, wsd

__all__ = ["AdamW", "AdamWState", "ErrorFeedback", "accumulate_grads",
           "clip_by_global_norm", "compress_bf16", "global_norm",
           "linear_warmup_cosine", "make_schedule", "value_and_grad", "wsd"]
