"""HTTP front of the port (counterpart of `deeplearning4j_tpu.ui`): the
`UiServer` (dashboard, classifier and LM serving) and the training
listener that posts to it."""

from deeplearning4j_tpu_torch.ui.listeners import HistogramIterationListener
from deeplearning4j_tpu_torch.ui.server import UiServer

__all__ = ["HistogramIterationListener", "UiServer"]
