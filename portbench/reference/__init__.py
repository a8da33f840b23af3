"""The plain reference: plain torch, no kernel, no TF32, and nothing of the
port (`local_search_quantization_torch`) or of JAX imported."""
