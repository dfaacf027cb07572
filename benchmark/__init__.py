"""The benchmark of the PyTorch and CUDA port (`nerf_fl_torch`): one
command runs one cell (`benchmark/run.py`); see `benchmark/README.md`."""
