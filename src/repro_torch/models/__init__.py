"""The port's LM models (counterpart of `repro.models`): the dense
decoders' serving path.  MoE, mamba, encoder–decoder and the VLM frontend
are still to port (ROADMAP item 16)."""
from .config import SHAPES, ModelConfig, ShapeCell, cell_applicable
from .model import Model, build_model

__all__ = ["SHAPES", "ModelConfig", "ShapeCell", "cell_applicable", "Model",
           "build_model"]
