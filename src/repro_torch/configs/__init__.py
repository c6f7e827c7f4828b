"""Model configurations: the ten architectures and the input shapes.

``input_specs`` (the dry-run's abstract batches) is not ported yet.
"""
from .base import ModelConfig, ShapeConfig, SHAPES, shape_applicable
from .archs import ARCHS, get_config

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "shape_applicable",
           "ARCHS", "get_config"]
