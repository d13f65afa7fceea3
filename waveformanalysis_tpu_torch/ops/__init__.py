"""Batched waveform ops (PyTorch counterparts of waveformanalysis_tpu.ops)."""
