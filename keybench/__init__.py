"""The benchmark of the PyTorch/CUDA port (`ecloop_tpu_torch`): one cell
per run (`run.py`), driven by BENCHMARK.json and the data files here."""
