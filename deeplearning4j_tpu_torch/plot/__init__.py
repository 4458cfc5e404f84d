"""Visualization math of the port (counterpart of
`deeplearning4j_tpu.plot`): exact t-SNE on the device, behind the UI's
``/tsne`` endpoints.  Barnes-Hut t-SNE, the renderers and the plotting
listeners are not ported (ROADMAP.md, A6)."""

from deeplearning4j_tpu_torch.plot.tsne import (
    Tsne,
    gaussian_perplexity,
    kl_divergence,
    tsne_fit,
    tsne_step,
)

__all__ = ["Tsne", "gaussian_perplexity", "kl_divergence", "tsne_fit",
           "tsne_step"]
