"""Utility tier of the port (counterpart of `deeplearning4j_tpu.utils`).

Only the Viterbi decoder is ported: it is the utility with device work
(the HMM tagger of `nlp/annotators.py` decodes on it).  The host-only
utilities — `counter`, `disk_queue`, `image_loader`, `math_utils`,
`moving_window` and `serialization` — are port slice 16 (ROADMAP.md,
A6).
"""

from deeplearning4j_tpu_torch.utils.viterbi import Viterbi

__all__ = ["Viterbi"]
