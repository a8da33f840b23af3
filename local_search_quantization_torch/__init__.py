"""local_search_quantization_torch — the LSQ pipeline in PyTorch and CUDA.

The PyTorch port of `local_search_quantization_tpu`, which stays the
reference. It keeps that package's module names and data model:

    X : [n, d]  float32      data, row-major
    B : [n, m]  int32        codes, 0-based (int64 inside for indexing)
    C : [m, h, d] float32    stacked codebooks
    R : [d, d]  float32      rotation

Functions take tensors and work on the device of their inputs; `Index`
(`index.py`) is the build / save / load / search surface. The kernels are
hand-written CUDA for Hopper (`csrc/`), built with nvcc at first use
(`_build.py`):

- K1 `csrc/ils_encode.cu`, the whole-ILS encoder (`ops/icm_kernels.py`);
- K5/K6 `csrc/icm_sweeps.cu`, the per-round ICM sweeps (`ops/icm_kernels.py`);
- K2 `csrc/scan_topk.cu`, the ADC scan with an exact top-k;
- K3 `csrc/scan_select.cu`, the same top-k streamed below a warm bound;
- K4 `csrc/scan_key.cu`, the bf16 key-append scan (K2-K4: `ops/select_kernels.py`).

Each has a plain PyTorch version beside it, which CPU tensors use. This
package never imports JAX.
"""

from local_search_quantization_torch.utils.config import LSQConfig

__version__ = "0.1.0"

__all__ = ["LSQConfig"]
