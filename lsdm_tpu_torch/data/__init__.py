"""Dataset loaders and the synthetic dataset generator."""
