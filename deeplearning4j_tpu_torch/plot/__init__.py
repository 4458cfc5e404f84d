"""Visualization math and renderers of the port (counterpart of
`deeplearning4j_tpu.plot`): exact t-SNE on the device, behind the UI's
``/tsne`` endpoints; Barnes-Hut t-SNE on the host (numpy, bitwise the
JAX package's); the weight / activation renderers and the plotting
iteration listeners, which read the network's tensors to the host and
write ``.npy`` grids where matplotlib is absent."""

from deeplearning4j_tpu_torch.plot.barnes_hut_tsne import BarnesHutTsne
from deeplearning4j_tpu_torch.plot.listeners import (
    ActivationRenderListener,
    PlotFiltersIterationListener,
)
from deeplearning4j_tpu_torch.plot.renderers import (
    FilterRenderer,
    NeuralNetPlotter,
)
from deeplearning4j_tpu_torch.plot.tsne import (
    Tsne,
    gaussian_perplexity,
    kl_divergence,
    tsne_fit,
    tsne_step,
)

__all__ = ["Tsne", "gaussian_perplexity", "kl_divergence", "tsne_fit",
           "tsne_step", "BarnesHutTsne", "FilterRenderer",
           "NeuralNetPlotter", "ActivationRenderListener",
           "PlotFiltersIterationListener"]
