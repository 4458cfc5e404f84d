"""Porter stemmer (counterpart of `deeplearning4j_tpu.nlp.stemmer`,
unchanged).

Parity: reference `text/annotator/StemmerAnnotator.java` (UIMA wrapper
around a Snowball stemmer). Self-contained Porter (1980) implementation —
no UIMA, usable as a token pre-processor in any tokenizer factory.
"""

from __future__ import annotations

_VOWELS = set("aeiou")


def _is_consonant(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_consonant(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Number of VC sequences."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        cons = _is_consonant(stem, i)
        if cons and prev_vowel:
            m += 1
        prev_vowel = not cons
    return m


def _contains_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_consonant(word, len(word) - 1))


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    if (_is_consonant(word, len(word) - 3)
            and not _is_consonant(word, len(word) - 2)
            and _is_consonant(word, len(word) - 1)):
        return word[-1] not in "wxy"
    return False


class PorterStemmer:
    def stem(self, word: str) -> str:
        w = word.lower()
        if len(w) <= 2:
            return w
        w = self._step1a(w)
        w = self._step1b(w)
        w = self._step1c(w)
        w = self._step2(w)
        w = self._step3(w)
        w = self._step4(w)
        w = self._step5(w)
        return w

    __call__ = stem

    # -- steps (Porter 1980) ------------------------------------------------
    def _step1a(self, w):
        if w.endswith("sses"):
            return w[:-2]
        if w.endswith("ies"):
            return w[:-2]
        if w.endswith("ss"):
            return w
        if w.endswith("s"):
            return w[:-1]
        return w

    def _step1b(self, w):
        if w.endswith("eed"):
            return w[:-1] if _measure(w[:-3]) > 0 else w
        flag = False
        if w.endswith("ed") and _contains_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith("ing") and _contains_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                return w + "e"
            if _ends_double_consonant(w) and not w.endswith(("l", "s", "z")):
                return w[:-1]
            if _measure(w) == 1 and _cvc(w):
                return w + "e"
        return w

    def _step1c(self, w):
        if w.endswith("y") and _contains_vowel(w[:-1]):
            return w[:-1] + "i"
        return w

    _STEP2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
              ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
              ("alli", "al"), ("entli", "ent"), ("eli", "e"),
              ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
              ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
              ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
              ("iviti", "ive"), ("biliti", "ble")]

    def _step2(self, w):
        for suf, rep in self._STEP2:
            if w.endswith(suf):
                stem = w[:-len(suf)]
                return stem + rep if _measure(stem) > 0 else w
        return w

    _STEP3 = [("icate", "ic"), ("ative", ""), ("alize", "al"),
              ("iciti", "ic"), ("ical", "ic"), ("ful", ""), ("ness", "")]

    def _step3(self, w):
        for suf, rep in self._STEP3:
            if w.endswith(suf):
                stem = w[:-len(suf)]
                return stem + rep if _measure(stem) > 0 else w
        return w

    _STEP4 = ["al", "ance", "ence", "er", "ic", "able", "ible", "ant",
              "ement", "ment", "ent", "ion", "ou", "ism", "ate", "iti",
              "ous", "ive", "ize"]

    def _step4(self, w):
        for suf in self._STEP4:
            if w.endswith(suf):
                stem = w[:-len(suf)]
                if _measure(stem) > 1:
                    if suf == "ion" and not stem.endswith(("s", "t")):
                        continue
                    return stem
                return w
        return w

    def _step5(self, w):
        if w.endswith("e"):
            stem = w[:-1]
            m = _measure(stem)
            if m > 1 or (m == 1 and not _cvc(stem)):
                w = stem
        if w.endswith("ll") and _measure(w) > 1:
            w = w[:-1]
        return w


class StemmingPreProcessor:
    """Token pre-processor slotting into the tokenizer factories (the role
    StemmerAnnotator played in the reference's UIMA pipeline)."""

    def __init__(self):
        self._stemmer = PorterStemmer()

    def pre_process(self, token: str) -> str:
        return self._stemmer.stem(token)

    __call__ = pre_process
