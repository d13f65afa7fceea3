"""Composed device programs (PyTorch counterparts of waveformanalysis_tpu.models)."""
