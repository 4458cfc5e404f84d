"""Tokenizer SPI + preprocessors (counterpart of
`deeplearning4j_tpu.nlp.tokenization`, unchanged).

Parity: reference `text/tokenization/` — `DefaultTokenizer` (Java
StringTokenizer semantics), `NGramTokenizer`, `TokenizerFactory` SPI,
`EndingPreProcessor` (crude suffix stemmer), `InputHomogenization`
(lowercase + punctuation strip). UIMA/PosUima tokenizers are represented by
the same SPI — plug any callable in via `TokenizerFactory(custom_fn)`.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Callable, List, Optional


class TokenPreProcess:
    """SPI: per-token preprocessing (reference TokenPreProcess)."""

    def pre_process(self, token: str) -> str:
        raise NotImplementedError

    def __call__(self, token: str) -> str:
        return self.pre_process(token)


class EndingPreProcessor(TokenPreProcess):
    """Crude suffix stripper (reference `EndingPreProcessor.java`): drops
    plural/verb endings so 'apples'→'apple', 'running'→'runn'."""

    def pre_process(self, token: str) -> str:
        if token.endswith("s") and not token.endswith("ss"):
            token = token[:-1]
        if token.endswith("."):
            token = token[:-1]
        if token.endswith("ly"):
            token = token[:-2]
        if token.endswith("ing"):
            token = token[:-3]
        return token


class InputHomogenization:
    """Sentence-level normalisation (reference `InputHomogenization.java`):
    lowercase, strip punctuation/accents."""

    def __init__(self, preserve_case: bool = False):
        self.preserve_case = preserve_case

    def transform(self, text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        text = re.sub(r"[^\w\s]", "", text)
        return text if self.preserve_case else text.lower()


class Tokenizer:
    """SPI matching the reference `Tokenizer` interface: hasMoreTokens /
    nextToken / getTokens, plus Python iteration."""

    def __init__(self, tokens: List[str],
                 pre_processor: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._i = 0
        self.pre_processor = pre_processor

    def has_more_tokens(self) -> bool:
        return self._i < len(self._tokens)

    def count_tokens(self) -> int:
        return len(self._tokens)

    def next_token(self) -> str:
        tok = self._tokens[self._i]
        self._i += 1
        return self.pre_processor(tok) if self.pre_processor else tok

    def get_tokens(self) -> List[str]:
        return [self.pre_processor(t) if self.pre_processor else t
                for t in self._tokens]

    def __iter__(self):
        return iter(self.get_tokens())


class DefaultTokenizer(Tokenizer):
    """Whitespace tokenization (reference `DefaultTokenizer` wraps Java
    StringTokenizer)."""

    def __init__(self, text: str,
                 pre_processor: Optional[TokenPreProcess] = None):
        super().__init__(text.split(), pre_processor)


class NGramTokenizer(Tokenizer):
    """Word n-grams from the base tokens (reference `NGramTokenizer`):
    emits every n-gram for n in [min_n, max_n] joined by spaces."""

    def __init__(self, text: str, min_n: int = 1, max_n: int = 2,
                 pre_processor: Optional[TokenPreProcess] = None):
        base = text.split()
        if pre_processor:
            base = [pre_processor(t) for t in base]
        grams: List[str] = []
        for n in range(min_n, max_n + 1):
            for i in range(len(base) - n + 1):
                grams.append(" ".join(base[i:i + n]))
        super().__init__(grams, None)


class TokenizerFactory:
    """SPI: creates Tokenizers (reference `TokenizerFactory`)."""

    def __init__(self, fn: Callable[..., Tokenizer] = DefaultTokenizer,
                 pre_processor: Optional[TokenPreProcess] = None, **kwargs):
        self._fn = fn
        self._kwargs = kwargs
        self.pre_processor = pre_processor

    def create(self, text: str) -> Tokenizer:
        return self._fn(text, pre_processor=self.pre_processor,
                        **self._kwargs)

    def tokenize(self, text: str) -> List[str]:
        return self.create(text).get_tokens()


class DefaultTokenizerFactory(TokenizerFactory):
    def __init__(self, pre_processor: Optional[TokenPreProcess] = None):
        super().__init__(DefaultTokenizer, pre_processor)


class NGramTokenizerFactory(TokenizerFactory):
    def __init__(self, min_n: int = 1, max_n: int = 2,
                 pre_processor: Optional[TokenPreProcess] = None):
        super().__init__(NGramTokenizer, pre_processor, min_n=min_n,
                         max_n=max_n)
