from ..kernels.adamw import global_norm
from .adamw import AdamWConfig, adamw_init, adamw_update, cosine_schedule

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
]
