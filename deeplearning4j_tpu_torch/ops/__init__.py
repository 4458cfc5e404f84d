"""Numerical building blocks of the port (counterpart of
`deeplearning4j_tpu.ops`): the gradient updaters so far."""
