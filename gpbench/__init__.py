"""gpbench: the benchmark of `gaussianprocesses_jl_tpu_torch` on one NVIDIA
H100. `BENCHMARK.json` at the root of the repository names its cells;
`python3 -m gpbench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one (`harness.py`). It measures the PyTorch package alone:
nothing it runs imports JAX or the JAX package."""
