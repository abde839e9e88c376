"""Static PHY description (DMRS, PUSCH grid) and the LS channel estimate."""
