"""Moving-window views over token sequences (counterpart of
`deeplearning4j_tpu.nlp.windows`, unchanged).

Parity: reference `text/movingwindow/Windows.java:189` + `Window.java` —
fixed-size context windows (padded with <s>/</s>) used by the windowed
classifiers and Viterbi-style taggers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

BEGIN = "<s>"
END = "</s>"


@dataclass
class Window:
    """One centered window (reference Window.java)."""
    words: List[str]
    focus_index: int
    label: str = ""

    @property
    def focus(self) -> str:
        return self.words[self.focus_index]

    def as_tokens(self) -> List[str]:
        return list(self.words)


def windows(tokens: Sequence[str], window_size: int = 5) -> List[Window]:
    """All windows of `window_size` centered on each token, edge-padded
    with BEGIN/END markers (reference Windows.windows)."""
    if window_size % 2 == 0:
        raise ValueError("window_size must be odd")
    half = window_size // 2
    padded = [BEGIN] * half + list(tokens) + [END] * half
    out = []
    for i in range(len(tokens)):
        out.append(Window(words=padded[i:i + window_size],
                          focus_index=half))
    return out
