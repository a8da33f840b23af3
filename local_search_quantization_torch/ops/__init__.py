"""Tensor ops of the LSQ path: LUTs, costs, ILS encode, solver, norms, ADC scan."""
