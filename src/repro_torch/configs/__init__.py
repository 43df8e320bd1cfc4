"""Architecture configs (one module per arch) and the assigned input
shapes.

``get_config(name)`` returns the full published config;
``smoke_config(name)`` the reduced same-family config of the CPU tests;
``ARCHS`` lists all ten architecture ids; ``SHAPES`` and ``cells_for``
give the four assigned shapes and the cells an arch runs.
"""

from .registry import ARCHS, get_config, smoke_config
from .shapes import SHAPES, Shape, cells_for, input_specs, shape_applicable

__all__ = [
    "ARCHS", "SHAPES", "Shape", "cells_for", "get_config",
    "input_specs", "shape_applicable", "smoke_config",
]
