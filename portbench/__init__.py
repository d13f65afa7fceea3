"""The benchmark of waveformanalysis_tpu_torch on an NVIDIA GPU.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Each piece is found by its name: a cell's deployment
in ``configs/<config>.json``, its traffic mix, a data file of parameters,
in ``traffic/<mix>.json``, its own settings (the limits of its check) in
``workloads/<cell>.json``; the mix's ``kind`` names the general driver
``kinds/<kind>.py`` and the plain reference ``reference/<kind>.py``; each
per-layer metric's reader is ``metrics/<metric>.py``. A metric named
``<quantity>.<part>`` (one quantity split by the cells that report it, as
``chain_roofline.64k``) falls back to the reader, and to the traffic
kind's value, of ``<quantity>``. The generators, the roofline counts and
the reference are frozen here: the program under test
is the PyTorch and CUDA package, and nothing in this folder imports JAX or
the JAX package.
"""
