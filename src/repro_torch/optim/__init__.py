from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                    adamw_update_, global_norm)
from repro_torch.optim.schedule import make_schedule

__all__ = ["adamw_init", "adamw_update", "adamw_update_", "global_norm",
           "make_schedule"]
