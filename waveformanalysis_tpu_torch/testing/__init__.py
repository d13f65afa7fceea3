"""Public testing fixtures for downstream plugin authors."""

from waveformanalysis_tpu_torch.testing.fixtures import (
    make_fake_st_waveforms,
    make_tiny_context,
)

__all__ = ["make_fake_st_waveforms", "make_tiny_context"]
