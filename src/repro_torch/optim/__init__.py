"""Optimizer and gradient compression (``repro.optim``)."""
