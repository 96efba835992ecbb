from repro_torch.common.types import (AdaptiveDepthConfig, INPUT_SHAPES,
                                      LAYER_KINDS, ModelConfig, ShapeConfig)

__all__ = ["AdaptiveDepthConfig", "INPUT_SHAPES", "LAYER_KINDS",
           "ModelConfig", "ShapeConfig"]
