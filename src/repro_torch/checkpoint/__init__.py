"""Atomic, resumable checkpoints (``repro.checkpoint``)."""
