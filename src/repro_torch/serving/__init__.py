from repro_torch.serving.engine import (EngineConfig, EngineStats,
                                        LatencyRing, NAIServingEngine,
                                        NaNGuardError, Request)
from repro_torch.serving.lm_engine import LMRequest, LMServingEngine

__all__ = ["EngineConfig", "EngineStats", "LatencyRing", "LMRequest",
           "LMServingEngine", "NAIServingEngine", "NaNGuardError", "Request"]
