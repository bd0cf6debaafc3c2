"""Architecture registry: ``get("phi3-mini-3.8b")`` etc."""

from .base import (
    ARCH_IDS,
    LONG_CONTEXT_ARCHS,
    REFERENCE_ARCH_IDS,
    SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
    XLSTMConfig,
    ZambaConfig,
    get,
    shapes_for,
)

__all__ = [
    "ARCH_IDS",
    "LONG_CONTEXT_ARCHS",
    "REFERENCE_ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "MoEConfig",
    "ShapeConfig",
    "SSMConfig",
    "TrainConfig",
    "XLSTMConfig",
    "ZambaConfig",
    "get",
    "shapes_for",
]
