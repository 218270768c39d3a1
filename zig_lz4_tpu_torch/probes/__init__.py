"""Counterparts of the JAX package's two retired Pallas kernels
(``experiments/pallas_decode.py`` and ``experiments/pallas_sort_probe.py``),
the only functions of the reference that reach ``pl.pallas_call``: each a
hand-written CUDA kernel with its plain PyTorch version.  The frame codec
does not use them; ``chip_smoke.py`` drives both."""
