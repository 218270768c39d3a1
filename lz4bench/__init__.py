"""The benchmark of ``zig_lz4_tpu_torch``, the PyTorch and CUDA port.

``python lz4bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; README.md
says how a configuration, a traffic mix, a cell or a metric is added
as new files.  Nothing here imports JAX or the JAX package.
"""
