"""portbench: the benchmark of the PyTorch and CUDA port (`vacnic_tpu_torch`).

One command runs one cell (`python3 -m portbench.run --workload <cell> ...`);
everything a cell needs is found by name under this folder (README.md).
"""
