"""The benchmark of the PyTorch and CUDA port (``mask_rcnn_tpu_torch``).

One command runs one cell once::

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository's root names the cells, the
configurations and the metrics; everything that belongs to one of them sits
in a file of its own under this package (``configs/``, ``traffic/``,
``limits/``, ``metrics/``), found by its name, and everything that belongs
to a model's architecture in ``archs/<architecture>.py``, which the
configuration names. ``reference/`` is the plain float32 model that decides
``correct``; it imports nothing of the port.
"""
