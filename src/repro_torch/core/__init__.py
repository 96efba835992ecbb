from repro_torch.core.inception_distill import (ensemble_teacher, hard_ce,
                                                offline_loss, online_loss,
                                                soft_ce,
                                                transformer_inception_loss)

__all__ = ["ensemble_teacher", "hard_ce", "offline_loss", "online_loss",
           "soft_ce", "transformer_inception_loss"]
