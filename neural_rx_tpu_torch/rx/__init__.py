"""Neural receiver: CGNN core and the PUSCH receiver around it."""
