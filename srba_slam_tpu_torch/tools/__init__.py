"""Measurement scripts run on a card (``python -m srba_slam_tpu_torch.tools.<name>``)."""
