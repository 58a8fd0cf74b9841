"""The benchmark of the PyTorch/CUDA port (`smilecode_tpu_torch`): one cell
of `BENCHMARK.json` per run of `bench_port/run.py`. See `README.md`."""
