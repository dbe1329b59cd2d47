"""Command-line entry points of the port (``python -m emcid_torch.cli.<name>``)."""
