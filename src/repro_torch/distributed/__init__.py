"""Fault tolerance of the serving fleet (replica health)."""
