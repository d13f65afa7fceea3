"""PyTorch/CUDA port of waveformanalysis_tpu.

Module paths mirror the JAX package (``ops/features.py`` here is the port
of ``waveformanalysis_tpu/ops/features.py``), and every public function
keeps the JAX package's event-major ``(n, L)`` layout, output keys and
dtypes. The package imports torch and numpy only, never jax.

Ported so far: the standalone fused chain (features -> find_peaks ->
threshold hits -> 10-90% widths -> S1/S2 label), whose main entry is
:func:`waveformanalysis_tpu_torch.ops.chain_scan_cuda.make_chain_scan`.
"""

__version__ = "0.1.0"
