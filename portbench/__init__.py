"""The benchmark of the PyTorch and CUDA port (`local_search_quantization_torch`).

Run a cell with `python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`; BENCHMARK.json at the checkout's root lists
the cells and metrics. Nothing here imports JAX or the JAX package.
"""
