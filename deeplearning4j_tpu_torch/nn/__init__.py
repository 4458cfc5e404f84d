"""Layer configurations and implementations (counterpart of
`deeplearning4j_tpu.nn`)."""
