"""Artifacts of the reference implementation: its weight files
(`reference_weights.py`)."""
