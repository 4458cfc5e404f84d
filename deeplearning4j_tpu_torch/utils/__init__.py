"""Utility tier of the port (counterpart of `deeplearning4j_tpu.utils`).

Parity: reference `deeplearning4j-core/.../util/` (MathUtils, Viterbi,
MovingWindowMatrix, DiskBasedQueue, SerializationUtils, ImageLoader) and
the vendored Berkeley-NLP `Counter` / `CounterMap`.  The Viterbi decoder
runs on the device (the HMM tagger of `nlp/annotators.py` decodes on
it); the rest are host helpers, copies of the JAX package's modules in
numpy and the standard library (`ImageLoader` imports Pillow when it
loads an image).
"""

from deeplearning4j_tpu_torch.utils.counter import Counter, CounterMap
from deeplearning4j_tpu_torch.utils.disk_queue import DiskBasedQueue
from deeplearning4j_tpu_torch.utils.image_loader import ImageLoader
from deeplearning4j_tpu_torch.utils.math_utils import (
    bernoulli_log_likelihood,
    correlation,
    cosine_similarity,
    entropy,
    euclidean_distance,
    information_gain,
    log2,
    manhattan_distance,
    normalize,
    sigmoid,
    ssq,
    uniform,
)
from deeplearning4j_tpu_torch.utils.moving_window import MovingWindowMatrix
from deeplearning4j_tpu_torch.utils.serialization import (
    load_object,
    save_object,
)
from deeplearning4j_tpu_torch.utils.viterbi import Viterbi

__all__ = [
    "Counter", "CounterMap", "DiskBasedQueue", "ImageLoader",
    "MovingWindowMatrix", "Viterbi", "save_object", "load_object",
    "sigmoid", "log2", "entropy", "information_gain", "normalize",
    "correlation", "cosine_similarity", "euclidean_distance",
    "manhattan_distance", "ssq", "uniform", "bernoulli_log_likelihood",
]
