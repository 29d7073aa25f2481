"""vsbench: the benchmark of raft_tpu_torch, the PyTorch and CUDA port.

``python3 -m vsbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell (``vsbench/run.py``). It measures the port only and
imports neither JAX nor the JAX package.
"""
