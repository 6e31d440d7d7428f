"""Diffusion schedules, DDPM math and the sampling loops."""
