"""Command-line entry points of repro_torch (``python -m repro_torch.launch.<name>``)."""
