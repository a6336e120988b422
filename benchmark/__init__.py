"""The benchmark of the PyTorch and CUDA port (``onepose_plus_plus_tpu_torch``)
on NVIDIA GPUs: ``python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (``benchmark/run.py``). Cells, metrics and
bounds are in ``BENCHMARK.json``; what they measure is in ``PERF.md``."""
