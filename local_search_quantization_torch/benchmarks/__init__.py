"""The port's twins of the JAX package's encoder benchmarks (`benchmarks/`,
`bench.py`), on PyTorch and the port's CUDA kernels.

Each runs as `python -m local_search_quantization_torch.benchmarks.<name>`
on the GPU, or with `--device cpu` on the CPU, and prints the card's name
and power limit first:

- `bench`: the headline ILS encode rate (K1), one JSON line;
- `bench_kernel_variants`: K7's dissections of K5's visit, beside K5 and K6;
- `bench_icm_phases`: the encode's phases (unaries, veccost, perturb, K5,
  gather and matmul sweeps);
- `bench_icm_modes`: the ILS rate per condition mode;
- `bench_ils_shapes`: K1 across (m, h) shapes;
- `bench_viterbi`: ChainQ's Viterbi encode rate;
- `bench_train_encode`: PQ and OPQ training, the LSQ-16 base encode of 1M.

Each exposes its sizes as function arguments, with the JAX script's shapes
as defaults.
"""
