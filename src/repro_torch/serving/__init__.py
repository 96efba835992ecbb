from repro_torch.serving.engine import (EngineConfig, EngineStats,
                                        LatencyRing, NAIServingEngine,
                                        NaNGuardError, Request)

__all__ = ["EngineConfig", "EngineStats", "LatencyRing", "NAIServingEngine",
           "NaNGuardError", "Request"]
