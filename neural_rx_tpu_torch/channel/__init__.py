"""Channel models (TDL, DoubleTDL, 38.901 UMi/UMa, the site-specific CIR
dataset), the carrier frequency offset and the channel's application."""
