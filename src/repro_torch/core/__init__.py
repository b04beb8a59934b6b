"""Core of the paper: DTW_p, envelopes, the bound family, cascade search."""
