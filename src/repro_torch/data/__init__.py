"""Synthetic data generators (numpy only), copied from ``repro.data``."""
