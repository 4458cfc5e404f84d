"""PyTorch port: the device Viterbi, the annotators and the sentiment
corpus (`utils/viterbi.py`, `nlp/annotators.py`, `nlp/sentiment.py`)
against the JAX package's, on the CPU.

- Viterbi: paths equal and log-probs within 1e-6 relative over several
  (T, S), T = 1 and exact ties included (both take the first index);
- the HMM tagger: the fitted tables equal, the tags equal on the seed
  corpus, held-out and unknown words; `default_tagger` keeps one tagger
  a device;
- `SWN3`: scores, bands and labels equal;
- `TreeParser`, `TreeVectorizer` and `sentiment_trees`: the parses of
  the seed corpus and of `MINI_REVIEWS` have equal tokens, labels and
  shape.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import annotators as jann
from deeplearning4j_tpu.nlp import sentiment as jsent
from deeplearning4j_tpu.utils import viterbi as jvit
from deeplearning4j_tpu_torch.nlp import annotators as tann
from deeplearning4j_tpu_torch.nlp import sentiment as tsent
from deeplearning4j_tpu_torch.utils import Viterbi
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

HELD_OUT = ["the quiet student reads in the library .",
            "three dogs chased the red ball .",
            "my friend and his sister sing loudly .",
            "the zorbulous quibbler vanished 42 times , 3.5 % faster !"]


def _shape(tree):
    """A tree as nested (label, word, children) tuples."""
    return (tree.label, tree.word, tuple(_shape(c) for c in tree.children))


def _hmm(t, s, seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        return (np.zeros((t, s)), np.zeros((s, s)), np.zeros(s))
    emit = np.log(rng.dirichlet(np.ones(s), size=t))
    trans = np.log(rng.dirichlet(np.ones(s) * 0.5, size=s))
    init = np.log(rng.dirichlet(np.ones(s)))
    return emit, trans, init


@pytest.mark.parametrize("t,s,seed,ties", [
    (1, 3, 0, False), (1, 45, 1, False), (2, 2, 2, False),
    (7, 5, 3, False), (30, 12, 4, False), (64, 45, 5, False),
    (9, 4, 0, True)])
def test_viterbi_matches_jax(t, s, seed, ties):
    emit, trans, init = _hmm(t, s, seed, ties)
    want_path, want_lp = jvit.Viterbi(trans, init, log_space=True).decode(
        emit, log_space=True)
    got_path, got_lp = Viterbi(trans, init, log_space=True,
                               device="cpu").decode(emit, log_space=True)
    assert got_path.dtype == np.int32 and got_path.shape == (t,)
    np.testing.assert_array_equal(got_path, np.asarray(want_path))
    assert abs(got_lp - want_lp) <= 1e-6 * max(abs(want_lp), 1e-30)
    if ties:
        assert got_path.tolist() == [0] * t


def test_viterbi_probability_space_and_uniform_prior_match_jax():
    emit, trans, _ = _hmm(12, 6, 7)
    want = jvit.Viterbi(np.exp(trans)).decode(np.exp(emit))
    got = Viterbi(np.exp(trans), device="cpu").decode(np.exp(emit))
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1] == pytest.approx(want[1], rel=1e-6)


def test_viterbi_reads_the_device_once_a_decode(monkeypatch):
    reads = []
    real = torch.Tensor.cpu

    def counting(self, *a, **k):
        reads.append(tuple(self.shape))
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    emit, trans, init = _hmm(20, 8, 9)
    Viterbi(trans, init, log_space=True, device="cpu").decode(
        emit, log_space=True)
    assert reads == [(19 * 8 + 2,)]


def test_hmm_tagger_tables_and_tags_match_jax():
    corpus = jann.seed_corpus()
    want = jann.HmmPosTagger(smoothing=0.2).fit(corpus[:40])
    got = tann.HmmPosTagger(smoothing=0.2, device="cpu").fit(
        tann.seed_corpus()[:40])
    assert got.tags == want.tags
    assert sorted(got._emit) == sorted(want._emit)
    for w, v in want._emit.items():
        np.testing.assert_array_equal(got._emit[w], v)
    for sfx, v in want._suffix.items():
        np.testing.assert_array_equal(got._suffix[sfx], v)
    for sent in corpus + [s.split() for s in HELD_OUT]:
        toks = [w if isinstance(w, str) else w[0] for w in sent]
        assert got.tag(toks) == want.tag(toks)
    assert got.tag([]) == []
    with pytest.raises(RuntimeError, match="not fitted"):
        tann.HmmPosTagger(device="cpu").tag(["a"])


def test_default_tagger_matches_jax_and_is_kept_a_device():
    tagger = tann.default_tagger("cpu")
    assert tann.default_tagger(torch.device("cpu")) is tagger
    assert tagger._viterbi.log_trans.device.type == "cpu"
    jtagger = jann.default_tagger()
    for sent in jann.seed_corpus():
        toks = [w for w, _ in sent]
        assert tagger.tag(toks) == jtagger.tag(toks)
    for text in HELD_OUT:
        assert tagger.tag_text(text) == jtagger.tag_text(text)


def test_swn3_matches_jax(tmp_path):
    j, t = jann.SWN3(), tann.SWN3()
    words = ["good", "Great", "terrible", "lazy", "storm", "well", "cat",
             "love", "poorly"]
    assert [t.word_score(w) for w in words] == [j.word_score(w)
                                                 for w in words]
    for _, text in jsent.MINI_REVIEWS + [(0, "not good at all"),
                                         (0, "never bad, would love")]:
        assert t.score(text) == j.score(text)
        assert t.classify(text) == j.classify(text)
        for c in (2, 3, 5):
            assert t.label(text, c) == j.label(text, c)
    lex = tmp_path / "swn.txt"
    lex.write_text("# comment\na\t1\t0.5\t0.25\tfine#1 ok#2\n"
                   "n\t2\t0\t0.5\tfine#3\nv\t3\t\t\tskip#1\n")
    assert (tann.SWN3(str(lex)).word_score("fine")
            == jann.SWN3(str(lex)).word_score("fine"))


def test_tree_parser_parses_match_jax():
    jp = jann.TreeParser()
    tp = tann.TreeParser(device="cpu")
    texts = [" ".join(w for w, _ in s) for s in jann.seed_corpus()]
    texts += [text for _, text in jsent.MINI_REVIEWS]
    for text in texts:
        want = jp.parse_text(text)
        got = tp.parse_text(text)
        assert [_shape(g) for g in got] == [_shape(w) for w in want]
        assert [g.tokens() for g in got] == [w.tokens() for w in want]
    assert tp.sentences("One. Two! Three?") == jp.sentences(
        "One. Two! Three?")
    with pytest.raises(ValueError, match="no tokens"):
        tp.parse(" . ")


def test_tree_vectorizer_and_sentiment_trees_match_jax():
    text = ("I love this great movie. This terrible film wastes your "
            "time. The weather is nice today.")
    want = jann.TreeVectorizer().vectorize(text)
    got = tann.TreeVectorizer(device="cpu").vectorize(text)
    assert [_shape(g) for g in got] == [_shape(w) for w in want]
    for labels in ("all", "root"):
        want = jsent.sentiment_trees(node_labels=labels)
        got = tsent.sentiment_trees(node_labels=labels, device="cpu")
        assert len(got) == len(want) >= 90
        assert [_shape(g) for g in got] == [_shape(w) for w in want]
    assert tsent.mini_reviews() == jsent.mini_reviews()
