"""SceneDiffusionModel and its building blocks."""
