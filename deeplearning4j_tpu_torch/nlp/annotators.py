"""Text annotators: HMM POS tagging, SentiWordNet sentiment scoring, and
raw-text constituency parsing (counterpart of
`deeplearning4j_tpu.nlp.annotators`).

Parity: the reference's UIMA annotator suite —
`text/annotator/PoStagger.java:248` (OpenNLP POS model behind a UIMA
AnalysisEngine), `text/corpora/sentiwordnet/SWN3.java:243` (SentiWordNet
3.0 lexicon scorer with rank-weighted sense averaging and threshold
classification), and `text/corpora/treeparser/TreeParser.java:427`
(OpenNLP chunker/parser -> Tree).  The UIMA/OpenNLP machinery is
dropped: tagging is an HMM decoded by the port's device Viterbi
(utils/viterbi.py), the lexicon scorer is pure table lookups, and parsing
is a deterministic POS-driven chunker producing the `Tree` objects RNTN
consumes.  The tagger decodes on `device` (the card unless
``device="cpu"``); `default_tagger` keeps one fitted tagger a device.
"""

from __future__ import annotations

import re
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.nlp.tree import Tree
from deeplearning4j_tpu_torch.utils.viterbi import Viterbi

# ---------------------------------------------------------------------------
# HMM POS tagger on the device Viterbi
# ---------------------------------------------------------------------------

TaggedSentence = Sequence[Tuple[str, str]]


class HmmPosTagger:
    """Bigram HMM part-of-speech tagger.

    Train with maximum-likelihood counts + add-k smoothing; decode with
    the device Viterbi (`utils/viterbi.py`, parity `util/Viterbi.java`)
    on `device` (the card unless ``device="cpu"``).
    Unknown words fall back to a suffix-keyed emission table (the
    classic open-class guesser), so raw corpora tag without an OOV crash
    — the capability PoStagger.java got from its pretrained OpenNLP
    model.
    """

    def __init__(self, smoothing: float = 0.1, suffix_len: int = 3,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.smoothing = smoothing
        self.suffix_len = suffix_len
        self.tags: List[str] = []
        self._tag_idx: Dict[str, int] = {}
        self._emit: Dict[str, np.ndarray] = {}
        self._suffix: Dict[str, np.ndarray] = {}
        self._open_class: Optional[np.ndarray] = None
        self._viterbi: Optional[Viterbi] = None

    def fit(self, tagged_sentences: Sequence[TaggedSentence]
            ) -> "HmmPosTagger":
        trans = Counter()
        emit = defaultdict(Counter)
        suffix = defaultdict(Counter)
        initial = Counter()
        tag_counts = Counter()
        for sent in tagged_sentences:
            prev = None
            for word, tag in sent:
                w = word.lower()
                tag_counts[tag] += 1
                emit[w][tag] += 1
                suffix[w[-self.suffix_len:]][tag] += 1
                if prev is None:
                    initial[tag] += 1
                else:
                    trans[(prev, tag)] += 1
                prev = tag
        self.tags = sorted(tag_counts)
        self._tag_idx = {t: i for i, t in enumerate(self.tags)}
        n = len(self.tags)
        k = self.smoothing

        tmat = np.full((n, n), k)
        for (a, b), c in trans.items():
            tmat[self._tag_idx[a], self._tag_idx[b]] += c
        tmat /= tmat.sum(axis=1, keepdims=True)

        init = np.full(n, k)
        for t, c in initial.items():
            init[self._tag_idx[t]] += c
        init /= init.sum()

        def to_logvec(counter: Counter) -> np.ndarray:
            v = np.full(n, k)
            for t, c in counter.items():
                v[self._tag_idx[t]] += c
            # P(word|tag) ∝ count(word,tag)/count(tag); constant factors
            # drop out of the argmax
            v = v / np.array([tag_counts[t] + k * n for t in self.tags])
            return np.log(v)

        self._emit = {w: to_logvec(c) for w, c in emit.items()}
        self._suffix = {s: to_logvec(c) for s, c in suffix.items()}
        open_counts = Counter(
            {t: c for t, c in tag_counts.items() if t not in (".", "X")})
        self._open_class = to_logvec(open_counts)
        self._viterbi = Viterbi(np.log(tmat), np.log(init), log_space=True,
                               device=self.device)
        return self

    def _emission(self, word: str) -> np.ndarray:
        w = word.lower()
        if w in self._emit:
            return self._emit[w]
        sfx = self._suffix.get(w[-self.suffix_len:])
        if sfx is not None:
            return sfx
        if re.fullmatch(r"[\d.,:%-]+", w):
            num = self._tag_idx.get("NUM")
            if num is not None:
                v = np.full(len(self.tags), -20.0)
                v[num] = 0.0
                return v
        return self._open_class

    def tag(self, tokens: Sequence[str]) -> List[Tuple[str, str]]:
        """Most likely tag sequence for a tokenized sentence."""
        if self._viterbi is None:
            raise RuntimeError("tagger not fitted")
        if not tokens:
            return []
        log_emit = np.stack([self._emission(t) for t in tokens])
        path, _ = self._viterbi.decode(log_emit, log_space=True)
        return [(tok, self.tags[int(i)]) for tok, i in zip(tokens, path)]

    def tag_text(self, text: str) -> List[Tuple[str, str]]:
        return self.tag(_tokenize(text))


def _tokenize(text: str) -> List[str]:
    return re.findall(r"[A-Za-z]+(?:'[A-Za-z]+)?|\d+(?:[.,]\d+)*|[^\sA-Za-z\d]",
                      text)


# A small embedded tagged corpus (hand-written, universal-ish tagset) so a
# default tagger exists without external downloads — the analog of the
# reference shipping a pretrained OpenNLP model on its classpath.
_SEED_CORPUS_TEXT = """
the/DET quick/ADJ brown/ADJ fox/NOUN jumps/VERB over/ADP the/DET lazy/ADJ dog/NOUN ./.
a/DET small/ADJ cat/NOUN sat/VERB on/ADP the/DET mat/NOUN ./.
she/PRON quickly/ADV reads/VERB a/DET long/ADJ book/NOUN ./.
he/PRON writes/VERB good/ADJ code/NOUN every/DET day/NOUN ./.
the/DET children/NOUN play/VERB in/ADP the/DET park/NOUN ./.
dogs/NOUN and/CONJ cats/NOUN are/VERB friendly/ADJ animals/NOUN ./.
i/PRON love/VERB this/DET great/ADJ movie/NOUN ./.
they/PRON walked/VERB slowly/ADV to/ADP the/DET old/ADJ house/NOUN ./.
we/PRON saw/VERB two/NUM birds/NOUN in/ADP a/DET tall/ADJ tree/NOUN ./.
the/DET weather/NOUN is/VERB very/ADV nice/ADJ today/NOUN ./.
john/NOUN gave/VERB mary/NOUN a/DET red/ADJ apple/NOUN ./.
my/PRON brother/NOUN runs/VERB fast/ADV ./.
the/DET big/ADJ storm/NOUN destroyed/VERB the/DET small/ADJ village/NOUN ./.
students/NOUN study/VERB hard/ADV for/ADP exams/NOUN ./.
she/PRON sings/VERB a/DET beautiful/ADJ song/NOUN ./.
the/DET sun/NOUN rises/VERB in/ADP the/DET east/NOUN ./.
birds/NOUN fly/VERB south/ADV in/ADP winter/NOUN ./.
he/PRON bought/VERB three/NUM new/ADJ books/NOUN yesterday/NOUN ./.
the/DET teacher/NOUN explains/VERB the/DET hard/ADJ lesson/NOUN ./.
a/DET good/ADJ friend/NOUN always/ADV helps/VERB ./.
this/DET terrible/ADJ film/NOUN wastes/VERB your/PRON time/NOUN ./.
the/DET happy/ADJ children/NOUN laughed/VERB loudly/ADV ./.
rain/NOUN falls/VERB softly/ADV on/ADP the/DET roof/NOUN ./.
we/PRON eat/VERB fresh/ADJ bread/NOUN and/CONJ cheese/NOUN ./.
the/DET old/ADJ man/NOUN walks/VERB with/ADP a/DET cane/NOUN ./.
my/PRON sister/NOUN paints/VERB bright/ADJ pictures/NOUN of/ADP flowers/NOUN ./.
the/DET tired/ADJ workers/NOUN finished/VERB the/DET long/ADJ project/NOUN ./.
four/NUM ships/NOUN sailed/VERB across/ADP the/DET calm/ADJ sea/NOUN ./.
she/PRON carefully/ADV opened/VERB the/DET heavy/ADJ wooden/ADJ door/NOUN ./.
the/DET doctor/NOUN and/CONJ the/DET nurse/NOUN help/VERB sick/ADJ patients/NOUN ./.
a/DET strong/ADJ wind/NOUN blew/VERB through/ADP the/DET quiet/ADJ valley/NOUN ./.
they/PRON often/ADV visit/VERB their/PRON grandmother/NOUN in/ADP spring/NOUN ./.
the/DET young/ADJ artist/NOUN draws/VERB beautiful/ADJ portraits/NOUN quickly/ADV ./.
five/NUM students/NOUN answered/VERB the/DET difficult/ADJ question/NOUN correctly/ADV ./.
the/DET river/NOUN flows/VERB slowly/ADV through/ADP the/DET green/ADJ fields/NOUN ./.
he/PRON never/ADV forgets/VERB an/DET important/ADJ meeting/NOUN ./.
the/DET hungry/ADJ wolves/NOUN hunted/VERB near/ADP the/DET dark/ADJ forest/NOUN ./.
our/PRON team/NOUN won/VERB the/DET final/ADJ match/NOUN easily/ADV ./.
a/DET clever/ADJ student/NOUN solves/VERB hard/ADJ problems/NOUN fast/ADV ./.
the/DET baker/NOUN sells/VERB warm/ADJ bread/NOUN every/DET morning/NOUN ./.
six/NUM horses/NOUN ran/VERB across/ADP the/DET open/ADJ plain/NOUN ./.
she/PRON wrote/VERB a/DET short/ADJ letter/NOUN to/ADP her/PRON mother/NOUN ./.
the/DET busy/ADJ market/NOUN opens/VERB early/ADV on/ADP saturday/NOUN ./.
i/PRON usually/ADV drink/VERB hot/ADJ coffee/NOUN with/ADP milk/NOUN ./.
the/DET brave/ADJ firefighter/NOUN saved/VERB the/DET frightened/ADJ child/NOUN ./.
small/ADJ boats/NOUN float/VERB on/ADP the/DET deep/ADJ lake/NOUN ./.
the/DET engineer/NOUN designs/VERB safe/ADJ bridges/NOUN and/CONJ roads/NOUN ./.
you/PRON should/VERB read/VERB this/DET interesting/ADJ article/NOUN ./.
the/DET gray/ADJ clouds/NOUN covered/VERB the/DET bright/ADJ sky/NOUN ./.
seven/NUM trees/NOUN grow/VERB behind/ADP the/DET white/ADJ fence/NOUN ./.
the/DET curious/ADJ tourists/NOUN photographed/VERB the/DET ancient/ADJ castle/NOUN ./.
my/PRON father/NOUN repairs/VERB broken/ADJ clocks/NOUN and/CONJ watches/NOUN ./.
the/DET singer/NOUN performed/VERB a/DET famous/ADJ song/NOUN tonight/NOUN ./.
wild/ADJ geese/NOUN fly/VERB north/ADV in/ADP early/ADJ summer/NOUN ./.
the/DET cook/NOUN prepares/VERB tasty/ADJ soup/NOUN with/ADP fresh/ADJ vegetables/NOUN ./.
eight/NUM players/NOUN practice/VERB on/ADP the/DET muddy/ADJ field/NOUN ./.
she/PRON always/ADV smiles/VERB at/ADP her/PRON little/ADJ brother/NOUN ./.
the/DET lazy/ADJ cat/NOUN sleeps/VERB under/ADP the/DET warm/ADJ blanket/NOUN ./.
a/DET sudden/ADJ noise/NOUN woke/VERB the/DET sleeping/ADJ baby/NOUN ./.
the/DET farmer/NOUN plants/VERB corn/NOUN and/CONJ beans/NOUN in/ADP april/NOUN ./.
we/PRON watched/VERB a/DET wonderful/ADJ film/NOUN last/ADJ night/NOUN ./.
the/DET mechanic/NOUN fixed/VERB the/DET old/ADJ engine/NOUN quickly/ADV ./.
two/NUM eagles/NOUN circled/VERB above/ADP the/DET rocky/ADJ mountain/NOUN ./.
the/DET polite/ADJ waiter/NOUN brought/VERB our/PRON delicious/ADJ dinner/NOUN ./.
heavy/ADJ rain/NOUN flooded/VERB the/DET narrow/ADJ streets/NOUN yesterday/NOUN ./.
the/DET librarian/NOUN quietly/ADV arranges/VERB the/DET new/ADJ books/NOUN ./.
he/PRON proudly/ADV showed/VERB us/PRON his/PRON first/ADJ medal/NOUN ./.
the/DET nervous/ADJ speaker/NOUN forgot/VERB his/PRON opening/ADJ line/NOUN ./.
nine/NUM candles/NOUN burned/VERB on/ADP the/DET birthday/NOUN cake/NOUN ./.
the/DET gardener/NOUN waters/VERB the/DET thirsty/ADJ plants/NOUN daily/ADV ./.
cold/ADJ winds/NOUN blow/VERB from/ADP the/DET northern/ADJ hills/NOUN ./.
the/DET pilot/NOUN lands/VERB the/DET huge/ADJ plane/NOUN smoothly/ADV ./.
she/PRON and/CONJ her/PRON friend/NOUN play/VERB chess/NOUN on/ADP sunday/NOUN ./.
the/DET angry/ADJ driver/NOUN honked/VERB at/ADP the/DET slow/ADJ truck/NOUN ./.
ten/NUM soldiers/NOUN guarded/VERB the/DET main/ADJ gate/NOUN carefully/ADV ./.
the/DET scientist/NOUN studies/VERB rare/ADJ butterflies/NOUN in/ADP the/DET jungle/NOUN ./.
a/DET gentle/ADJ breeze/NOUN moves/VERB the/DET yellow/ADJ leaves/NOUN ./.
the/DET judge/NOUN listened/VERB to/ADP the/DET long/ADJ argument/NOUN patiently/ADV ./.
my/PRON uncle/NOUN builds/VERB strong/ADJ wooden/ADJ tables/NOUN ./.
the/DET children/NOUN happily/ADV opened/VERB their/PRON colorful/ADJ presents/NOUN ./.
fresh/ADJ snow/NOUN covered/VERB the/DET silent/ADJ village/NOUN overnight/ADV ./.
the/DET manager/NOUN calmly/ADV explained/VERB the/DET new/ADJ rules/NOUN ./.
bright/ADJ stars/NOUN shine/VERB over/ADP the/DET peaceful/ADJ desert/NOUN ./.
"""


def seed_corpus() -> List[List[Tuple[str, str]]]:
    out = []
    for line in _SEED_CORPUS_TEXT.strip().splitlines():
        sent = []
        for pair in line.split():
            word, tag = pair.rsplit("/", 1)
            sent.append((word, tag))
        out.append(sent)
    return out


_default_taggers: Dict[torch.device, HmmPosTagger] = {}


def default_tagger(device: DeviceLike = None) -> HmmPosTagger:
    """The seed-corpus tagger on `device`, fitted once a device."""
    dev = resolve_device(device)
    if dev not in _default_taggers:
        _default_taggers[dev] = HmmPosTagger(device=dev).fit(seed_corpus())
    return _default_taggers[dev]


# ---------------------------------------------------------------------------
# SentiWordNet scorer (SWN3.java parity)
# ---------------------------------------------------------------------------

class SWN3:
    """SentiWordNet 3.0 scorer.

    Lexicon format (the official distribution, SWN3.java:70-105):
    ``POS \\t id \\t posScore \\t negScore \\t term#rank [term#rank ...]``.
    Each term's senses are combined rank-weighted (1/rank, normalized by
    the harmonic number) exactly like the reference; text scoring sums
    token scores with negation-window sign flipping; classification uses
    the same seven sentiment bands (classForScore, SWN3.java:152-167)."""

    NEGATION_WORDS = {
        "could", "would", "should", "not", "no", "never", "isn't",
        "aren't", "wasn't", "weren't", "haven't", "doesn't", "didn't",
        "don't", "cannot", "can't", "won't",
    }
    _POS_ORDER = ("a", "n", "v", "r")

    def __init__(self, lexicon_path: Optional[str] = None):
        self._dict: Dict[str, float] = {}
        if lexicon_path is not None:
            self._load(Path(lexicon_path).read_text())
        else:
            self._load(_MINI_SENTIWORDNET)

    def _load(self, text: str) -> None:
        temp: Dict[str, Dict[int, float]] = defaultdict(dict)
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            data = line.split("\t")
            if len(data) < 5 or not data[2] or not data[3]:
                continue
            score = float(data[2]) - float(data[3])
            for w in data[4].split(" "):
                if not w or "#" not in w:
                    continue
                term, rank = w.rsplit("#", 1)
                temp[f"{term}#{data[0]}"][int(rank) - 1] = score
        for word, senses in temp.items():
            num = sum(s / (i + 1) for i, s in senses.items())
            den = sum(1.0 / i for i in range(1, max(senses) + 2))
            self._dict[word] = num / den

    def word_score(self, word: str) -> float:
        """Rank-weighted score, first matching POS (a, n, v, r)."""
        w = word.lower()
        for pos in self._POS_ORDER:
            key = f"{w}#{pos}"
            if key in self._dict:
                return self._dict[key]
        return 0.0

    def score_tokens(self, tokens: Sequence[str]) -> float:
        """Sum of token scores; a negation word flips the sign of the
        following sentiment-bearing token (SWN3.scoreTokens)."""
        total = 0.0
        negate = False
        for tok in tokens:
            w = tok.lower()
            if w in self.NEGATION_WORDS:
                negate = True
                continue
            s = self.word_score(w)
            if s != 0.0:
                total += -s if negate else s
                negate = False
        return total

    def score(self, text: str) -> float:
        return self.score_tokens(_tokenize(text))

    @staticmethod
    def class_for_score(score: float) -> str:
        if score >= 0.75:
            return "strong_positive"
        if score > 0.5:
            return "positive"
        if score > 0.0:
            return "weak_positive"
        if score == 0.0:
            return "neutral"
        if score >= -0.5:
            return "weak_negative"
        if score > -0.75:
            return "negative"
        return "strong_negative"

    def classify(self, text: str) -> str:
        return self.class_for_score(self.score(text))

    def label(self, text: str, num_classes: int = 5) -> int:
        """Sentiment band -> integer class (SST-style 0..4 for 5-class)."""
        s = self.score(text)
        if num_classes == 2:
            return int(s > 0)
        edges = np.linspace(-0.75, 0.75, num_classes - 1)
        return int(np.searchsorted(edges, s, side="right"))


# Embedded starter lexicon in the official SentiWordNet format (a tiny
# hand-curated subset; pass lexicon_path for the real 117k-entry file).
_MINI_SENTIWORDNET = """
a\t1\t0.75\t0\tgood#1 great#2
a\t2\t0.875\t0\texcellent#1 wonderful#2 fantastic#3
a\t3\t0\t0.75\tbad#1 awful#2
a\t4\t0\t0.875\tterrible#1 horrible#2
a\t5\t0.625\t0\thappy#1 glad#2
a\t6\t0\t0.625\tsad#1 unhappy#2
a\t7\t0.5\t0\tnice#1 pleasant#2
a\t8\t0\t0.5\tugly#1 nasty#2
a\t9\t0.625\t0\tbeautiful#1 lovely#2
a\t10\t0\t0.625\tpoor#1 lousy#2
a\t11\t0.5\t0.125\tfriendly#1
a\t12\t0.375\t0\tfresh#1
a\t13\t0\t0.375\tboring#1 dull#2
a\t14\t0.25\t0\tbig#2 tall#3
a\t15\t0\t0.25\tlazy#1
v\t16\t0.5\t0\tlove#1 enjoy#2
v\t17\t0\t0.5\thate#1 dislike#2
v\t18\t0.375\t0\thelp#1
v\t19\t0\t0.5\tdestroy#1 waste#2
v\t20\t0.25\t0\tlaugh#1
n\t21\t0.375\t0\tfriend#1
n\t22\t0\t0.375\tstorm#2 problem#1
n\t23\t0.25\t0\tsun#2
r\t24\t0.25\t0\twell#1 nicely#2
r\t25\t0\t0.25\tbadly#1 poorly#2
"""


# ---------------------------------------------------------------------------
# Raw-text constituency parsing (TreeParser.java parity)
# ---------------------------------------------------------------------------

class TreeParser:
    """Deterministic POS-driven chunker producing `Tree` objects.

    The reference (TreeParser.java:427) runs text through an OpenNLP
    constituency parser; this redesign tags with the HMM tagger, groups
    tokens into NP/VP/PP chunks with standard patterns, and combines the
    chunks right-branching into a binarized S — enough structure for the
    RNTN's strictly binary combine (models/rntn.py) to train on raw
    sentences."""

    NP_TAGS = {"DET", "ADJ", "NOUN", "PRON", "NUM"}
    VP_TAGS = {"VERB", "ADV"}

    def __init__(self, tagger: Optional[HmmPosTagger] = None,
                 labeler=None, device: DeviceLike = None):
        self.tagger = tagger or default_tagger(device)
        # labeler: tokens -> int label for the root/leaf nodes (e.g. an
        # SWN3-based sentiment labeler); None leaves labels at 0 so RNTN
        # consumers can relabel.
        self.labeler = labeler

    def sentences(self, text: str) -> List[str]:
        return [s.strip() for s in re.split(r"(?<=[.!?])\s+", text.strip())
                if s.strip()]

    def parse(self, sentence: str) -> Tree:
        tagged = self.tagger.tag_text(sentence)
        tagged = [(w, t) for w, t in tagged if t != "."]
        if not tagged:
            raise ValueError(f"no tokens in sentence {sentence!r}")
        label = (self.labeler([w for w, _ in tagged])
                 if self.labeler else 0)
        chunks: List[Tree] = []
        i = 0
        while i < len(tagged):
            word, tag = tagged[i]
            group = [Tree(label=label, word=word)]
            fam = (self.NP_TAGS if tag in self.NP_TAGS
                   else self.VP_TAGS if tag in self.VP_TAGS else None)
            j = i + 1
            while fam is not None and j < len(tagged) and tagged[j][1] in fam:
                group.append(Tree(label=label, word=tagged[j][0]))
                j += 1
            chunks.append(group[0] if len(group) == 1
                          else Tree(label=label, children=group))
            i = j
        root = chunks[-1]
        for left in reversed(chunks[:-1]):
            root = Tree(label=label, children=[left, root])
        return root.binarize()

    def parse_text(self, text: str) -> List[Tree]:
        return [self.parse(s) for s in self.sentences(text)]


class TreeVectorizer:
    """Raw corpus -> labeled trees for RNTN training (reference
    TreeVectorizer.java: parse + attach labels). The default labeler is
    the SWN3 sentiment band, matching the reference's sentiment
    pipeline."""

    def __init__(self, parser: Optional[TreeParser] = None,
                 swn: Optional[SWN3] = None, num_classes: int = 5,
                 device: DeviceLike = None):
        self.swn = swn or SWN3()
        self.num_classes = num_classes
        self.parser = parser or TreeParser(
            labeler=lambda toks: self.swn.label(" ".join(toks),
                                                self.num_classes),
            device=device)

    def vectorize(self, text: str) -> List[Tree]:
        return self.parser.parse_text(text)
