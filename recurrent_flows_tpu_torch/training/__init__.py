from .trainer import preprocess

__all__ = ["preprocess"]
