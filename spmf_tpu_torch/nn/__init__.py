from .dense import DenseHorseshoe

__all__ = ["DenseHorseshoe"]
