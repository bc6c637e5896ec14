"""The port's benchmark: cells named in ``BENCHMARK.json``, driven by data.

Run one cell with ``python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the repository root. See ``run.py``.
"""
