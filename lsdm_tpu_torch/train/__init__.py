"""Training: optimizer state, the train step and the epoch loop."""
