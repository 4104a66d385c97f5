"""Measurement tools of the port (``python -m llava_plus_torch.tools.<name>``)."""
