"""Host-side utilities: the logger bridge and matplotlib pictures."""

from .logger import logger, test_logger
from .plotting import plot

__all__ = ["logger", "test_logger", "plot"]
