"""Dataset configuration."""

from .config import DatasetConfig

__all__ = ["DatasetConfig"]
