"""The LM substrate's models: layers, attention and the decoder LM."""
from .transformer import LM, params_from_numpy
from . import attention, layers, moe, ssm

__all__ = ["LM", "params_from_numpy", "attention", "layers", "moe", "ssm"]
