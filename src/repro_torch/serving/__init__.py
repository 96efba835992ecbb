from repro_torch.serving.engine import (EngineConfig, EngineStats,
                                        LatencyRing, NAIServingEngine, Request)
from repro_torch.serving.faults import (FaultPlan, FaultSpec, FaultyStore,
                                        InjectedFault, NaNGuardError,
                                        WatchdogTimeout)
from repro_torch.serving.frontend import (BreakerConfig, CircuitBreaker,
                                          ClassStats, ServingFrontend,
                                          SLOClass, default_slo_classes)
from repro_torch.serving.lm_engine import LMRequest, LMServingEngine

__all__ = ["EngineConfig", "EngineStats", "LatencyRing", "NAIServingEngine",
           "Request", "FaultPlan", "FaultSpec", "FaultyStore",
           "InjectedFault", "NaNGuardError", "WatchdogTimeout",
           "BreakerConfig", "CircuitBreaker", "ClassStats",
           "ServingFrontend", "SLOClass", "default_slo_classes",
           "LMRequest", "LMServingEngine"]
