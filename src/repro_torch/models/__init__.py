"""The port's LM models (counterpart of `repro.models`): every family of
the zoo (dense, MoE, mamba2, the attention/mamba hybrid, encoder–decoder
and the VLM patch stub), served and trained."""
from .config import SHAPES, ModelConfig, ShapeCell, cell_applicable
from .model import Model, build_model

__all__ = ["SHAPES", "ModelConfig", "ShapeCell", "cell_applicable", "Model",
           "build_model"]
