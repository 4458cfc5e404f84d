"""The benchmark of the PyTorch / CUDA port (`deeplearning4j_tpu_torch`):
one cell a run, ``python3 -m benchmark.run``; see README.md."""
