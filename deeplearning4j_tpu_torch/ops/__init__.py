"""Numerical building blocks of the port (counterpart of
`deeplearning4j_tpu.ops`): activations, initializers, losses and the
gradient updaters."""
