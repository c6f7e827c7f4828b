"""The LM substrate's models: layers, attention, MoE, Mamba-2, the
unified LM and its single-token decode."""
from .transformer import LM, params_from_numpy
from . import attention, decode, layers, moe, ssm

__all__ = ["LM", "params_from_numpy", "attention", "decode", "layers", "moe",
           "ssm"]
