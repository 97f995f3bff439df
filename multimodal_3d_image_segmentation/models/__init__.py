"""Model zoo: all four reference architectures.

Exports mirror the reference ``nets/__init__.py:11-12`` so config-driven
model lookup (``getattr(models, model_name)``) works identically.
"""
from .architectures import (HartleyMHABlock, HartleyMHASeg,
                            NeuralOperatorBlock, NeuralOperatorSeg, VNetDS)
from .hnosegxs import HNOSegXS, HNOXSBlock

__all__ = ["VNetDS", "NeuralOperatorSeg", "HartleyMHASeg", "HNOSegXS",
           "NeuralOperatorBlock", "HartleyMHABlock", "HNOXSBlock"]
