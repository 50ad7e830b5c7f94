from .logging import get_logger, setup_logging

__all__ = ["get_logger", "setup_logging"]
