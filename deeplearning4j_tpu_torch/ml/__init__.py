"""High-level estimator/pipeline API (counterpart of
`deeplearning4j_tpu.ml`).

Parity: reference `dl4j-spark-ml` (Scala) — Spark ML pipeline integration:
`MultiLayerNetworkClassification.scala:47` (Estimator whose train() runs
ParameterAveragingTrainingStrategy, model predicts on the driver),
`MultiLayerNetworkReconstruction.scala` (unsupervised hidden-layer
transform), `ml/Unsupervised.scala`.  Without Spark, estimators wrap
the port's `MultiLayerNetwork` on one card behind the
fit/transform/predict convention Python ML code expects (the JAX
package's data-parallel option is ROADMAP.md queue A7).
"""

from deeplearning4j_tpu_torch.ml.pipeline import (
    NetworkClassifier,
    NetworkReconstruction,
    Pipeline,
    StandardScaler,
)
from deeplearning4j_tpu_torch.ml.sources import (
    SOURCES,
    DataSource,
    load_source,
    source_schema,
)

__all__ = [
    "NetworkClassifier",
    "NetworkReconstruction",
    "Pipeline",
    "StandardScaler",
    "DataSource",
    "SOURCES",
    "load_source",
    "source_schema",
]
