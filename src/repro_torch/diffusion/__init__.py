"""Diffusion schedule and the single-shot pipeline."""
