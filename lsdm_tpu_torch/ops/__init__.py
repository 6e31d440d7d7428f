"""Point-cloud ops, attention, embeddings and the CUDA kernel wrappers."""
