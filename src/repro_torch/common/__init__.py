from repro_torch.common.types import (H100_SXM, INPUT_SHAPES, LAYER_KINDS,
                                      AdaptiveDepthConfig, HardwareConfig,
                                      MeshConfig, ModelConfig, ShapeConfig,
                                      TrainConfig)

__all__ = ["AdaptiveDepthConfig", "H100_SXM", "HardwareConfig",
           "INPUT_SHAPES", "LAYER_KINDS", "MeshConfig", "ModelConfig",
           "ShapeConfig", "TrainConfig"]
