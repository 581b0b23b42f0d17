"""NumPy problem generators shared with the JAX package's tests."""

from .generate import random_equality_hierarchy, random_inequality_hierarchy

__all__ = ["random_equality_hierarchy", "random_inequality_hierarchy"]
