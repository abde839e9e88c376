"""Experiment configuration (INI parsing + PUSCH/grid assembly)."""
