"""The port's twins of the serving command line (`scripts/`), on PyTorch and
the port's CUDA kernels:

- `build_index`: train a quantizer, encode the base set, write an index
  directory (`Index.build` + `save`);
- `serve`: the long-lived server, JSON lines and binary frames on
  stdin/stdout, the protocol of `scripts/serve.py` byte for byte;
- `eval_index`: the offline recall check of an index directory.

Each runs as `python -m local_search_quantization_torch.scripts.<name>` from
the repo root, or as a file from any directory, on the GPU unless given
`--device cpu`, and raises without a GPU otherwise. An index directory
written by either package's `build_index` serves and evaluates in the other.
"""
