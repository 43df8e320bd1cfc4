"""Architecture configs the port supports so far."""

from .registry import ARCHS, get_config, smoke_config

__all__ = ["ARCHS", "get_config", "smoke_config"]
