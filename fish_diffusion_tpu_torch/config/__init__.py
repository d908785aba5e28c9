from .config import Config

__all__ = ["Config"]
