"""Channel application (the channel models wait for the next eval slice)."""
