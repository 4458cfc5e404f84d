"""Bundled mini sentiment corpus + labeled trees for RNTN gates
(counterpart of `deeplearning4j_tpu.nlp.sentiment`).

Parity role: the reference's RNTN pipeline trains on the labeled Stanford
Sentiment Treebank fed through its tree parser
(`models/rntn/RNTN.java:82`, `text/corpora/treeparser/TreeParser.java:427`,
exercised by `BasicRNTNTest`).  Offline, no treebank download exists, so
the framework ships this hand-written movie/product-review corpus: real
English sentences with genuine binary sentiment, parsed by the in-package
`TreeParser` (PoStagger -> chunker, the reference call stack; the tagger
decodes on the card unless ``device="cpu"``) into labeled `Tree`s that
`models.rntn.RNTN` consumes directly.

Labels: 0 = negative, 1 = positive, applied to every node of a
sentence's tree (weak labeling: the per-node supervision of the real
SST is unavailable for hand-authored data; the root is what the gate
scores, matching `RNTNEval` root accuracy).
"""

from __future__ import annotations

from typing import List, Tuple

from deeplearning4j_tpu_torch.device import DeviceLike
from deeplearning4j_tpu_torch.nlp.annotators import TreeParser
from deeplearning4j_tpu_torch.nlp.tree import Tree

# (label, sentence): 1 positive / 0 negative.  Authored so that (a) each
# sentiment cue word RECURS in several different sentences — a held-out
# sentence's cues are in-vocabulary, as in real review corpora — and
# (b) templates are shared across both classes with different cues, so
# the sentence frame carries no class signal; the cue words do.
MINI_REVIEWS: List[Tuple[int, str]] = [
    (1, "this movie is wonderful from start to finish"),
    (1, "a brilliant performance anchors this wonderful film"),
    (1, "the plot is gripping and the pacing is superb"),
    (1, "i found the whole show delightful and moving"),
    (1, "a moving story told with brilliant craft"),
    (1, "the acting is superb and the script is sharp"),
    (1, "an excellent adventure with a gripping finale"),
    (1, "the cast delivers an excellent and heartfelt show"),
    (1, "a delightful comedy built on sharp writing"),
    (1, "the visuals are stunning and the music is gorgeous"),
    (1, "a funny and deeply satisfying movie"),
    (1, "the director delivers a stunning piece of work"),
    (1, "every scene feels fresh and inspired"),
    (1, "a charming film with a moving message"),
    (1, "the characters are charming and wonderfully drawn"),
    (1, "this album sounds fresh and completely inspired"),
    (1, "a gripping thriller with a satisfying ending"),
    (1, "the book is brilliant and rewarding"),
    (1, "an inspiring tale with a gorgeous setting"),
    (1, "the food was excellent and the service was charming"),
    (1, "a superb blend of humor and heart"),
    (1, "the performances are heartfelt and honest"),
    (1, "this game is polished and great fun"),
    (1, "a wonderful surprise with a satisfying payoff"),
    (1, "the writing is sharp and genuinely funny"),
    (1, "a moving and rewarding experience"),
    (1, "the new season is fresh and frequently brilliant"),
    (1, "the hotel was lovely and the staff were delightful"),
    (1, "the ending is honest and deeply satisfying"),
    (1, "a fascinating documentary with stunning photography"),
    (1, "the leads share a charming and funny chemistry"),
    (1, "a bold and rewarding piece of work"),
    (1, "this restaurant serves excellent pasta with lovely service"),
    (1, "a tender love story with gorgeous photography"),
    (1, "the soundtrack is inspired and elevates the film"),
    (1, "a heartfelt comedy that is funny and honest"),
    (1, "the craftsmanship here is polished and superb"),
    (1, "a lovely gem with a heartfelt core"),
    (1, "the lecture was inspiring and wonderfully clear"),
    (1, "a thrilling ride with an inspired payoff"),
    (1, "this phone is fast polished and a pleasure"),
    (1, "the garden looked lovely and fresh this morning"),
    (1, "an honest film made with brilliant care"),
    (1, "the team gave a superb and inspired effort"),
    (1, "a glorious and satisfying return for the studio"),
    (1, "the novel builds to a rewarding and honest finale"),
    (1, "a stunning and tender film about hope"),
    (1, "the show stays funny and charming all season"),
    (0, "this movie is terrible from start to finish"),
    (0, "a dull performance sinks this boring film"),
    (0, "the plot is tedious and the pacing is sloppy"),
    (0, "i found the whole show dull and lifeless"),
    (0, "a clumsy story told with lazy craft"),
    (0, "the acting is wooden and the script is weak"),
    (0, "a tedious adventure with a predictable finale"),
    (0, "the cast delivers an awful and lifeless show"),
    (0, "a painful comedy built on stale writing"),
    (0, "the visuals are cheap and the music is grating"),
    (0, "a hollow and deeply boring movie"),
    (0, "the director delivers a sloppy piece of work"),
    (0, "every scene feels stale and lazy"),
    (0, "a dreary film with a hollow message"),
    (0, "the characters are dull and poorly drawn"),
    (0, "this album sounds stale and completely derivative"),
    (0, "a dreary thriller with a predictable ending"),
    (0, "the book is clumsy and forgettable"),
    (0, "a depressing tale with a grating tone"),
    (0, "the food was bland and the service was rude"),
    (0, "an awful mix of noise and boredom"),
    (0, "the performances are wooden and fake"),
    (0, "this game is buggy and no fun"),
    (0, "a nasty surprise with a cheap payoff"),
    (0, "the writing is weak and painfully unfunny"),
    (0, "a tedious and forgettable experience"),
    (0, "the new season is stale and frequently awful"),
    (0, "the hotel was dirty and the staff were rude"),
    (0, "the ending is abrupt and deeply unsatisfying"),
    (0, "a shallow documentary with cheap photography"),
    (0, "the leads share a painful and wooden chemistry"),
    (0, "a timid and tiresome piece of work"),
    (0, "this restaurant serves bland pasta with rude service"),
    (0, "a cold love story with dreary photography"),
    (0, "the soundtrack is grating and ruins the film"),
    (0, "a heartless comedy that is unfunny and fake"),
    (0, "the craftsmanship here is sloppy and shoddy"),
    (0, "a dismal dud with a hollow core"),
    (0, "the lecture was boring and painfully vague"),
    (0, "a sluggish ride with a predictable payoff"),
    (0, "this phone is slow buggy and a pain"),
    (0, "the garden looked neglected and dreary this morning"),
    (0, "a dishonest film made with lazy care"),
    (0, "the team gave a sloppy and timid effort"),
    (0, "a dismal and unsatisfying low point for the studio"),
    (0, "the novel collapses into a botched and clumsy finale"),
    (0, "a grating and cold film about nothing"),
    (0, "the show stays dull and lifeless all season"),
]


def mini_reviews() -> List[Tuple[int, str]]:
    """The bundled (label, sentence) sentiment corpus."""
    return list(MINI_REVIEWS)


def sentiment_trees(parser=None, reviews=None, node_labels: str = "all",
                    device: DeviceLike = None) -> List[Tree]:
    """Parse the review corpus with the in-package TreeParser (PoStagger
    -> chunker — the reference's TreeParser.java role) into RNTN-ready
    labeled trees.

    node_labels: "all" weak-labels every node with the sentence class
    (the shape of fully-labeled SST training); "root" labels only the
    root — interior nodes stay unsupervised via TreeProgram.labeled.
    Without a `parser`, the default one tags on `device`."""
    parser = parser or TreeParser(device=device)
    out = []
    for label, text in (reviews if reviews is not None else MINI_REVIEWS):
        trees = parser.parse_text(text)
        if not trees:
            continue
        tree = trees[0]
        for node in tree.nodes():
            node.label = label if node_labels == "all" else None
        tree.label = label
        out.append(tree)
    return out
