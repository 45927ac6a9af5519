"""The plain reference: the steps that the benchmark times, written again
in plain PyTorch from their published descriptions and the arithmetic of
the warp, with no kernel, no autocast and nothing of the program
(`peclr_tpu_torch`) or of JAX."""
