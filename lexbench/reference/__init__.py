"""The plain reference (NumPy): it imports neither the port nor the JAX package."""
