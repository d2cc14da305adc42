"""Synthetic training data (``repro.data``)."""
