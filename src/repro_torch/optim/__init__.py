from .adamw import (AdamWState, adamw_init, adamw_update,  # noqa: F401
                    clip_by_global_norm, cosine_schedule)
