"""Command-line entry points of the port (``python -m
recurrent_flows_tpu_torch.cli.<name>``)."""
