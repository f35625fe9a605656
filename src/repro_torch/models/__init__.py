from .config import (ModelConfig, ShapeSpec, ALL_SHAPES, SHAPES_BY_NAME,
                     applicable_shapes)  # noqa: F401
