"""The benchmark of the PyTorch + CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON result line.  Everything a cell needs is found by name:
its configuration under ``configs/``, the model kind that configuration
names under ``models/``, its traffic mix under ``traffic/``, its
correctness limits under ``limits/`` and each per-layer metric's reader
(with any hooks it has into a traced run) under ``readers/``.  Nothing
here imports JAX or the JAX package ``repro``; ``reference/`` imports
nothing of the port either, and a model kind reaches the port only in
its ``model_config``.
"""
