"""The benchmark of scrooge_tpu_torch: read mapping through ``align_reads``.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. The cells,
configurations and metrics are listed in ``BENCHMARK.json`` at the root;
each cell's files are found by name (``cells.py``). Everything that
measures (the input generator, the plain reference that decides
``correct``, the bound arithmetic and the trace reduction) lives in this
folder; from the package under test it takes only ``align_reads``,
``prepare_genome``, its data types, its ``AlignStats`` counters and its
kernel names. Nothing here imports JAX or the JAX package ``scrooge_tpu``.
"""
