from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_init_specs,
                                     adamw_update, clip_by_global_norm)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamWState", "adamw_init", "adamw_init_specs", "adamw_update",
           "clip_by_global_norm", "cosine_schedule", "linear_warmup_cosine"]
