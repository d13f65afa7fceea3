"""PyTorch/CUDA port of waveformanalysis_tpu.

Module paths mirror the JAX package (``ops/features.py`` here is the port
of ``waveformanalysis_tpu/ops/features.py``), and every public function
keeps the JAX package's event-major ``(n, L)`` layout, output keys and
dtypes. The package imports torch and numpy only, never jax.

Ported so far: slice 1, the standalone fused chain (features -> find_peaks
-> threshold hits -> 10-90% widths -> S1/S2 label), main entry
:func:`waveformanalysis_tpu_torch.ops.chain_scan_cuda.make_chain_scan`;
slice 2, the Context route ``Context.get_data(run, ["s1_s2",
"hit_threshold"])`` (:mod:`waveformanalysis_tpu_torch.context.context`).
Device work runs on CUDA unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
