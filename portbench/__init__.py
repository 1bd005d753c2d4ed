"""The benchmark of the PyTorch and CUDA port (hifimeth_tpu_torch): see
run.py for the command and BENCHMARK.json for the cells."""
