"""Model configurations: the ten architectures, the input shapes and the
dry-run's input stand-ins (``input_specs``)."""
from .base import ModelConfig, ShapeConfig, SHAPES, shape_applicable
from .archs import ARCHS, get_config
from . import input_specs

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "shape_applicable",
           "ARCHS", "get_config", "input_specs"]
