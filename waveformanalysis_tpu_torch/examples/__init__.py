"""Runnable examples of the port (``python -m waveformanalysis_tpu_torch.examples.<name>``)."""
