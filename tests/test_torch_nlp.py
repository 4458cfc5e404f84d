"""PyTorch port: the word-embedding family of `nlp/` against the JAX
package, on the CPU.

- The pure-Python modules (tokenizers, stemmer, sentence and document
  iterators, vectorizers, inverted index, windows, the Word2Vec ->
  DataSet bridge) give equal outputs on the same inputs.
- `VocabCache` order, Huffman codes and points, `hs_arrays` and the
  negative table are equal exactly.
- Whole fits (`Word2Vec` HS; NEG with JAX's negatives replayed into the
  port's draw; `ParagraphVectors.fit_labelled`, `infer_vector`; GloVe
  `fit` and `partial_fit`; multi-chunk staging): tables within 1e-5
  absolute, GloVe's epoch losses within 1e-5 relative.
- Files written by `serde` are byte-identical both ways and load in the
  other package.
- The behaviours of the JAX package's `TestWord2Vec`, `TestGlove` and
  `TestParagraphVectors` hold on the port; with no card the entry points
  raise.
- The float32 bound `chip_smoke.py` holds the card's steps to: a step run
  in another summation order (a shuffled batch, standing in for the
  card's atomics) stays within it of the float64 recompute, where the old
  fixed card-vs-CPU rule (1e-5 relative) fails.
"""

import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nlp as jnlp
from deeplearning4j_tpu.nlp import stemmer as jstem
from deeplearning4j_tpu.nlp import vocab as jvocab
from deeplearning4j_tpu.nlp import windows as jwin
from deeplearning4j_tpu.nlp.invertedindex import InvertedIndex as JIndex
from deeplearning4j_tpu_torch import nlp as tnlp
from deeplearning4j_tpu_torch.models import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nlp import stemmer as tstem
from deeplearning4j_tpu_torch.nlp import vocab as tvocab
from deeplearning4j_tpu_torch.nlp import windows as twin
from deeplearning4j_tpu_torch.nlp import word2vec as tw2v
from deeplearning4j_tpu_torch.nlp.invertedindex import InvertedIndex as TIndex
from deeplearning4j_tpu_torch.nn import conf as tconf
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

ATOL = 1e-5
CPU = {"device": "cpu"}

# the two-topic corpus of tests/test_nlp.py
FRUIT = ["apple", "banana", "cherry", "mango", "grape"]
TECH = ["cpu", "gpu", "ram", "disk", "cache"]


def make_corpus(n=600, seed=0):
    rng = np.random.default_rng(seed)
    sentences = []
    for i in range(n):
        topic = FRUIT if i % 2 == 0 else TECH
        sentences.append(" ".join(rng.choice(topic, size=6)))
    return sentences


CORPUS = make_corpus()
LABELS = ["fruit" if i % 2 == 0 else "tech" for i in range(len(CORPUS))]


def zipf_corpus(n=120, vocab=80, seed=0):
    """Skewed word frequencies with ties, for the vocab and Huffman."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    p = 1.0 / np.arange(1, vocab + 1)
    return [" ".join(rng.choice(words, int(rng.integers(3, 12)),
                                p=p / p.sum())) for _ in range(n)]


def replay_negatives(jmodel, seed, split=True):
    """The port's `_negatives` replaced by JAX's draws: `PRNGKey(seed)`,
    one split a batch (`Word2Vec.fit`, `fit_labelled`) or the key itself
    (`infer_vector`), `randint` into JAX's unigram table."""
    table = np.asarray(jmodel._neg_table)
    state = {"key": jax.random.PRNGKey(seed)}

    def draw(gen, n):
        sub = state["key"]
        if split:
            state["key"], sub = jax.random.split(state["key"])
        idx = np.asarray(jax.random.randint(sub, (n, jmodel.negative), 0,
                                            table.shape[0]))
        return torch.from_numpy(table[idx]).long()
    return draw


# ---------------------------------------------------------------------------
# pure-Python modules: equal outputs

TEXTS = ["Hello world foo", "a b c d", "  spaced\tout\nlines  ",
         "Héllo, World! It's running.", "apples running quickly cats."]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizers_and_preprocessors_equal(text):
    for name in ("DefaultTokenizer", "NGramTokenizer"):
        jt, tt = getattr(jnlp, name)(text), getattr(tnlp, name)(text)
        assert tt.get_tokens() == jt.get_tokens()
        assert tt.count_tokens() == jt.count_tokens()
    for kw in ({"min_n": 1, "max_n": 3}, {"min_n": 2, "max_n": 2}):
        assert (tnlp.NGramTokenizerFactory(**kw).tokenize(text)
                == jnlp.NGramTokenizerFactory(**kw).tokenize(text))
    pre_j, pre_t = jnlp.EndingPreProcessor(), tnlp.EndingPreProcessor()
    assert (tnlp.DefaultTokenizerFactory(pre_t).tokenize(text)
            == jnlp.DefaultTokenizerFactory(pre_j).tokenize(text))
    for keep in (False, True):
        assert (tnlp.InputHomogenization(keep).transform(text)
                == jnlp.InputHomogenization(keep).transform(text))


def test_porter_stemmer_equal():
    words = ["caresses", "ponies", "cats", "agreed", "plastered",
             "motoring", "happy", "relational", "conditional", "rational",
             "generalization", "probate", "cease", "Running", "hopping",
             "filing", "sized", "feed", "troubled", "electrical",
             "hopefulness", "adjustable", "controll", "roll", "a", "by"]
    js, ts = jstem.PorterStemmer(), tstem.PorterStemmer()
    assert [ts.stem(w) for w in words] == [js.stem(w) for w in words]
    pre_j, pre_t = jstem.StemmingPreProcessor(), tstem.StemmingPreProcessor()
    assert [pre_t(w) for w in words] == [pre_j(w) for w in words]


def test_sentence_and_document_iterators_equal(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "a" / "1.txt").write_text("one two\n\nthree four\n")
    (tmp_path / "b" / "2.txt").write_text("five six\nseven\n")
    (tmp_path / "b" / "3.md").write_text("eight\n")
    line = tmp_path / "a" / "1.txt"
    assert (list(tnlp.CollectionSentenceIterator(["a b", "c"], str.upper))
            == list(jnlp.CollectionSentenceIterator(["a b", "c"],
                                                    str.upper)))
    assert (list(tnlp.LineSentenceIterator(line))
            == list(jnlp.LineSentenceIterator(line)))
    assert (list(tnlp.FileSentenceIterator(tmp_path))
            == list(jnlp.FileSentenceIterator(tmp_path)))
    ji = jnlp.LabelAwareSentenceIterator(["x y", "z"], ["p", "q"], str.upper)
    ti = tnlp.LabelAwareSentenceIterator(["x y", "z"], ["p", "q"], str.upper)
    assert list(ti.pairs()) == list(ji.pairs())
    assert [(s, ti.current_label()) for s in ti] == \
        [(s, ji.current_label()) for s in ji]
    with pytest.raises(ValueError):
        tnlp.LabelAwareSentenceIterator(["a"], [])
    assert (list(tnlp.CollectionDocumentIterator(["d1", "d2"]))
            == list(jnlp.CollectionDocumentIterator(["d1", "d2"])))
    for suffix in ("", ".txt"):
        assert (list(tnlp.FileDocumentIterator(tmp_path, suffix))
                == list(jnlp.FileDocumentIterator(tmp_path, suffix)))
        jl = jnlp.LabelAwareDocumentIterator(root=tmp_path, suffix=suffix)
        tl = tnlp.LabelAwareDocumentIterator(root=tmp_path, suffix=suffix)
        assert list(tl.pairs()) == list(jl.pairs())
        assert tl.label_set() == jl.label_set()
    with pytest.raises(ValueError):
        tnlp.LabelAwareDocumentIterator(documents=["a"], labels=[])


DOCS = ["the apple banana apple", "cpu gpu cpu gpu the", "banana cherry",
        "the cpu", ""]


@pytest.mark.parametrize("kind", ["CountVectorizer", "TfidfVectorizer"])
@pytest.mark.parametrize("knobs", [{}, {"min_word_frequency": 2},
                                   {"max_features": 3}])
def test_vectorizers_equal(kind, knobs):
    jv, tv = getattr(jnlp, kind)(**knobs), getattr(tnlp, kind)(**knobs)
    np.testing.assert_array_equal(tv.fit_transform(DOCS),
                                  jv.fit_transform(DOCS))
    query = ["apple apple gpu the", "nothing known"]
    np.testing.assert_array_equal(tv.transform(query), jv.transform(query))
    jd = jv.vectorize(DOCS, [0, 1, 0, 1, 2])
    td = tv.vectorize(DOCS, [0, 1, 0, 1, 2])
    np.testing.assert_array_equal(td.features, jd.features)
    np.testing.assert_array_equal(td.labels, jd.labels)
    assert td.labels.shape == (5, 3)


def test_inverted_index_and_windows_equal():
    ji, ti = JIndex(), TIndex()
    for words in (["apple", "banana"], ["apple", "cpu"], ["cpu"]):
        assert ti.add_doc(words) == ji.add_doc(words)
    ji.add_word_to_doc(5, "late")
    ti.add_word_to_doc(5, "late")
    for w in ("apple", "cpu", "late", "none"):
        assert ti.documents(w) == ji.documents(w)
    assert ti.num_documents() == ji.num_documents() == 6
    assert ti.all_docs() == ji.all_docs()
    assert (list(ti.sample_batches(4, 3, seed=1))
            == list(ji.sample_batches(4, 3, seed=1)))
    assert list(ti.eachDocWithLabel()) == list(ji.eachDocWithLabel())
    for size in (1, 3, 5):
        tw = twin.windows(["a", "b", "c", "d"], size)
        jw = jwin.windows(["a", "b", "c", "d"], size)
        assert [(w.words, w.focus) for w in tw] == \
            [(w.words, w.focus) for w in jw]
    with pytest.raises(ValueError):
        twin.windows(["a"], 4)


def _vocab_pair(corpus, **kw):
    toks = [s.split() for s in corpus]
    jv = jvocab.VocabCache(**kw).fit(toks)
    tv = tvocab.VocabCache(**kw).fit(toks)
    jvocab.Huffman(jv).build()
    tvocab.Huffman(tv).build()
    return jv, tv


@pytest.mark.parametrize("kw", [{}, {"min_word_frequency": 3},
                                {"max_words": 17}])
@pytest.mark.parametrize("seed", [0, 1])
def test_vocab_huffman_and_negative_table_equal_exactly(kw, seed):
    jv, tv = _vocab_pair(zipf_corpus(seed=seed), **kw)
    assert [tv.word_at(i) for i in range(len(tv))] == \
        [jv.word_at(i) for i in range(len(jv))]
    for w, jw in jv.words.items():
        tw = tv.words[w]
        assert (tw.count, tw.index, tw.codes, tw.points) == \
            (jw.count, jw.index, jw.codes, jw.points)
    for a, b in zip(tv.hs_arrays(), jv.hs_arrays()):
        np.testing.assert_array_equal(a, b)
    for size, power in ((100_000, 0.75), (997, 0.5)):
        np.testing.assert_array_equal(
            tvocab.build_negative_table(tv, size, power),
            jvocab.build_negative_table(jv, size, power))
    enc = ["w1", "zzz", "w0", "w40"]
    np.testing.assert_array_equal(tv.encode(enc), jv.encode(enc))
    assert tv.total_word_count() == jv.total_word_count()


def test_huffman_of_one_word_and_of_ties():
    jv, tv = _vocab_pair(["a a a"])
    assert tv.words["a"].codes == jv.words["a"].codes == [0]
    words = ["a", "b", "c", "d", "e", "f"]        # every count ties
    jv, tv = _vocab_pair([" ".join(words)])
    for w in words:
        assert (tv.words[w].codes, tv.words[w].points) == \
            (jv.words[w].codes, jv.words[w].points)


# ---------------------------------------------------------------------------
# whole fits against the JAX package


def _w2v_pair(cls_name="Word2Vec", **kw):
    return (getattr(jnlp, cls_name)(**kw),
            getattr(tnlp, cls_name)(**kw, **CPU))


def _tables_close(t, j):
    np.testing.assert_allclose(t.syn0, np.asarray(j.syn0), atol=ATOL, rtol=0)
    for name in ("syn1", "syn1neg"):
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=0)


def test_word2vec_hs_fit_matches_jax():
    kw = dict(vector_length=16, window=3, epochs=2, seed=3, batch_size=128)
    j, t = _w2v_pair(**kw)
    j.fit(CORPUS[:200])
    t.fit(CORPUS[:200])
    _tables_close(t, j)
    # a warm second fit keeps the weights and trains on
    j.fit(CORPUS[200:260])
    t.fit(CORPUS[200:260])
    _tables_close(t, j)


@pytest.mark.parametrize("subsample", [0.0, 0.05])
def test_word2vec_neg_fit_matches_jax_with_its_negatives(subsample):
    kw = dict(vector_length=12, window=3, epochs=2, seed=4, negative=5,
              batch_size=128, subsample=subsample)
    j, t = _w2v_pair(**kw)
    j.fit(CORPUS[:160])
    t.build_vocab(t._sentences_to_tokens(CORPUS[:160]))
    t._negatives = replay_negatives(j, kw["seed"])
    t.fit(CORPUS[:160])
    _tables_close(t, j)


def test_multi_chunk_staging_matches_one_chunk_and_jax(monkeypatch):
    sents = zipf_corpus(n=60, vocab=50, seed=4)
    kw = dict(vector_length=16, window=3, negative=0, epochs=2,
              batch_size=64, seed=9)
    j, t = _w2v_pair(**kw)
    j.fit(sents)
    one_chunk = t.fit(sents).syn0
    monkeypatch.setattr(tw2v, "STAGE_PAIRS", 128)     # 2 batches a chunk
    many = tnlp.Word2Vec(**kw, **CPU).fit(sents).syn0
    np.testing.assert_array_equal(one_chunk, many)
    np.testing.assert_allclose(many, np.asarray(j.syn0), atol=ATOL, rtol=0)


@pytest.mark.parametrize("negative", [0, 5])
def test_paragraph_vectors_fit_and_infer_match_jax(negative):
    kw = dict(vector_length=16, window=3, epochs=2, seed=2, batch_size=256,
              learning_rate=0.025, negative=negative)
    j, t = _w2v_pair("ParagraphVectors", **kw)
    j.fit_labelled(CORPUS[:120], LABELS[:120])
    if negative:
        t._negatives = replay_negatives(j, kw["seed"])
    t.fit_labelled(CORPUS[:120], LABELS[:120])
    assert t.labels == j.labels
    _tables_close(t, j)
    # inference from the same frozen output weights
    t.syn1, t.syn1neg = j.syn1, j.syn1neg
    if negative:
        t._negatives = replay_negatives(j, kw["seed"] + 1, split=False)
    words = ["mango", "grape", "apple", "notaword", "cpu"]
    np.testing.assert_allclose(t.infer_vector(words, steps=30),
                               j.infer_vector(words, steps=30),
                               atol=ATOL, rtol=0)
    assert not t.infer_vector(["notaword"]).any()


def test_glove_fit_and_partial_fit_match_jax():
    kw = dict(vector_length=8, window=4, epochs=6, seed=3, x_max=10.0,
              batch_size=256)
    j, t = _w2v_pair("Glove", **kw)
    j.fit(CORPUS[:150])
    t.fit(CORPUS[:150])
    np.testing.assert_allclose(t.losses, j.losses, rtol=ATOL)
    np.testing.assert_allclose(t.syn0, j.syn0, atol=ATOL, rtol=0)
    j.partial_fit(CORPUS[150:190], epochs=2)
    t.partial_fit(CORPUS[150:190], epochs=2)
    np.testing.assert_allclose(t.syn0, j.syn0, atol=ATOL, rtol=0)
    for tp, jp in zip(t._params + t._adagrad, j._params + j._adagrad):
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL,
                                   rtol=0)


def test_word_vector_queries_match_jax():
    vecs = np.random.default_rng(0).standard_normal((30, 8)).astype(
        np.float32)
    jv, tv = _vocab_pair(zipf_corpus(n=60, vocab=30))
    vecs = vecs[:len(jv)]
    j = jnlp.word_vectors.WordVectors(jv, vecs)
    t = tnlp.WordVectors(tv, vecs, **CPU)
    for w in ("w0", "w3", "w7"):
        assert t.words_nearest(w, 5) == j.words_nearest(w, 5)
    assert t.words_nearest(vecs[2], 4, exclude=["w1"]) == \
        j.words_nearest(vecs[2], 4, exclude=["w1"])
    assert t.analogy("w0", "w1", "w2", 3) == j.analogy("w0", "w1", "w2", 3)
    assert t.similarity("w0", "w1") == j.similarity("w0", "w1")
    assert t.words_nearest("nope") == j.words_nearest("nope") == []


def test_serde_files_are_byte_identical_and_load_across(tmp_path):
    w = tnlp.Word2Vec(vector_length=12, epochs=1, seed=5, **CPU)
    w.fit(CORPUS[:100])
    j = jnlp.word_vectors.WordVectors(w.vocab, w.syn0)
    for writer, reader in (("write_word_vectors", "load_txt_vectors"),
                           ("write_binary_model", "read_binary_model")):
        tp, jp = tmp_path / f"t_{writer}", tmp_path / f"j_{writer}"
        getattr(tnlp, writer)(w, tp)
        getattr(jnlp, writer)(j, jp)
        assert tp.read_bytes() == jp.read_bytes()
        from_t = getattr(jnlp, reader)(tp)        # the port's file in JAX
        from_j = getattr(tnlp, reader)(jp, **CPU)  # and the other way
        assert from_j.vocab._index == from_t.vocab._index == w.vocab._index
        np.testing.assert_array_equal(from_j.syn0, np.asarray(from_t.syn0))
        if writer == "write_binary_model":
            np.testing.assert_array_equal(from_j.syn0, w.syn0)
        else:
            np.testing.assert_allclose(from_j.syn0, w.syn0, rtol=1e-5)


def test_load_txt_vectors_tolerates_ragged_whitespace(tmp_path):
    p = tmp_path / "v.txt"
    p.write_text("3 3\napple 1.0  2.0 3.0 \nbanana 4.0 5.0 6.0\t\n")
    wv = tnlp.load_txt_vectors(p, **CPU)
    assert len(wv.vocab) == 2
    np.testing.assert_allclose(wv.get_word_vector("banana"), [4, 5, 6])


def test_word2vec_dataset_iterator_equal_and_feeds_the_network():
    corpus = ["the cat sat on the mat", "the dog sat on the log",
              "cats and dogs are animals", "the quick brown fox jumps"] * 4
    w = tnlp.Word2Vec(vector_length=12, window=5, negative=5, epochs=2,
                      seed=1, **CPU).fit(corpus)
    j = jnlp.word_vectors.WordVectors(w.vocab, w.syn0)
    pairs = ([(s, "pets") for s in corpus[:2]]
             + [(s, "wild") for s in ("the fox runs far", "a wild wolf",
                                      "the bear sleeps")])
    ti = tnlp.Word2VecDataSetIterator(w, pairs, ["pets", "wild"], batch=8,
                                      window_size=3)
    ji = jnlp.Word2VecDataSetIterator(j, pairs, ["pets", "wild"], batch=8,
                                      window_size=3)
    tb, jb = list(ti), list(ji)
    assert len(tb) == len(jb) > 1
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
    assert ti.input_columns == 36
    net = TNet(tconf.MultiLayerConfiguration(
        conf=tconf.NeuralNetConfiguration(learning_rate=0.05,
                                          updater="adam", seed=2),
        layers=(tconf.DenseLayerConf(n_in=ti.input_columns, n_out=16,
                                     activation="relu"),
                tconf.OutputLayerConf(n_in=16, n_out=2))), **CPU).init()
    net.fit(ti, epochs=30)
    ds = ti.all_data()
    assert net.evaluate(ds.features, ds.labels).accuracy() > 0.8


# ---------------------------------------------------------------------------
# the JAX package's behaviours, on the port


@pytest.mark.parametrize("negative", [0, 5])
def test_topics_separate(negative):
    w2v = tnlp.Word2Vec(vector_length=24, window=3, epochs=5, seed=1,
                        negative=negative, batch_size=512,
                        learning_rate=0.025, **CPU)
    w2v.fit(CORPUS)
    within = w2v.similarity("apple", "banana")
    across = w2v.similarity("apple", "gpu")
    assert within > across + 0.2, (within, across)
    assert set(w2v.words_nearest("cpu", top_n=4)) <= set(TECH) - {"cpu"}


def test_oov_and_similarity_nan():
    w2v = tnlp.Word2Vec(vector_length=8, epochs=1, **CPU).fit(CORPUS[:50])
    assert w2v.get_word_vector("notaword") is None
    assert np.isnan(w2v.similarity("apple", "notaword"))


@pytest.mark.parametrize("negative", [0, 5])
def test_seeded_fits_are_bitwise_equal(negative):
    def run():
        w = tnlp.Word2Vec(vector_length=16, window=3, epochs=3, seed=7,
                          batch_size=256, negative=negative, **CPU)
        return w.fit(CORPUS[:80]).syn0
    np.testing.assert_array_equal(run(), run())


def test_inline_pairgen_matches_threaded_bitwise(monkeypatch):
    def train(cores):
        monkeypatch.setattr(os, "cpu_count", lambda: cores)
        m = tnlp.Word2Vec(vector_length=12, window=2, epochs=2, seed=3,
                          negative=5, batch_size=256, **CPU)
        return m.fit(CORPUS[:60]).syn0
    np.testing.assert_array_equal(train(2), train(1))


def test_glove_topics_separate_and_losses_fall():
    glove = tnlp.Glove(vector_length=16, window=4, epochs=30, seed=3,
                       x_max=10.0, **CPU).fit(CORPUS)
    assert glove.losses[-1] < glove.losses[0]
    assert glove.similarity("apple", "cherry") > \
        glove.similarity("apple", "ram")


@pytest.fixture(scope="module")
def pv():
    p = tnlp.ParagraphVectors(vector_length=24, window=3, epochs=5, seed=2,
                              batch_size=512, learning_rate=0.025, **CPU)
    return p.fit_labelled(CORPUS, LABELS)


def test_paragraph_vectors_label_prediction(pv):
    assert pv.predict(["apple", "banana", "grape"]) == "fruit"
    assert pv.predict(["cpu", "disk", "cache"]) == "tech"
    assert pv.predict(["notaword"]) is None


ORDERS = (1, 2, 3, 4)


@pytest.mark.parametrize("knobs", [{}, {"batch_size": 128},
                                   {"negative": 5}],
                         ids=["jax_test_hs_batch_512", "hs_batch_128",
                              "neg_batch_512"])
def test_label_prediction_against_the_summation_order(monkeypatch, knobs):
    """The card's ``index_add_`` adds a batch's duplicate rows in atomic
    order; here each step's adds go in a random order instead.  At the
    settings `chip_smoke.py` holds ParagraphVectors to, the labels come
    out right in every order; at the JAX test's (HS, batch 512: ~50 adds
    into each label's row a batch) some order predicts a wrong label,
    which is why the card only records that fit."""
    orig = torch.Tensor.index_add_
    right = []
    for seed in ORDERS:
        gen = torch.Generator().manual_seed(seed)

        def shuffled(self, dim, index, source, alpha=1):
            order = torch.randperm(index.shape[0], generator=gen)
            return orig(self, dim, index[order], source[order], alpha=alpha)
        monkeypatch.setattr(torch.Tensor, "index_add_", shuffled)
        p = tnlp.ParagraphVectors(**{**dict(
            vector_length=24, window=3, epochs=5, seed=2, batch_size=512,
            learning_rate=0.025), **knobs}, **CPU)
        p.fit_labelled(CORPUS, LABELS)
        right.append((p.predict(["apple", "banana", "grape"]),
                      p.predict(["cpu", "disk", "cache"]))
                     == ("fruit", "tech"))
    if knobs:
        assert all(right), right
    else:
        assert not all(right), right


def test_bench_neg_row_is_not_finite_in_either_package():
    """A reference-side fault the port copies (ROADMAP queue C): bench.py's
    Word2Vec row (NEG, batch 4096, a zipf corpus of 2 000 words) adds
    hundreds of same-row updates a batch with no clip and trains
    non-finite tables in the JAX package; the port, held to it, does the
    same."""
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(2000)]
    zipf = 1.0 / np.arange(1, 2001)
    ids = rng.choice(2000, size=120_000, p=zipf / zipf.sum())
    sents = [" ".join(words[i] for i in ids[k:k + 16])
             for k in range(0, len(ids), 16)]
    j, t = _w2v_pair(vector_length=128, window=5, negative=5, epochs=1,
                     batch_size=4096)
    j.fit(sents)
    t.fit(sents)
    assert not np.isfinite(np.asarray(j.syn0)).all()
    assert not np.isfinite(t.syn0).all()


def test_paragraph_vectors_infer_vector(pv):
    vec = pv.infer_vector(["mango", "grape", "apple"])
    assert vec.shape == (24,)
    fr, te = pv.get_label_vector("fruit"), pv.get_label_vector("tech")

    def cos(a, b):
        return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos(vec, fr) > cos(vec, te)


def test_labels_survive_min_word_frequency():
    p = tnlp.ParagraphVectors(vector_length=16, window=3, epochs=2, seed=2,
                              batch_size=256, min_word_frequency=2, **CPU)
    p.fit_labelled(CORPUS, LABELS)
    assert p.get_label_vector("fruit") is not None
    assert p.get_label_vector("tech") is not None
    with pytest.raises(ValueError):
        p.fit_labelled(CORPUS, LABELS[:-1])


def test_entry_points_need_a_card_or_the_cpu_by_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (tnlp.Word2Vec, tnlp.ParagraphVectors, tnlp.Glove):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls()
        assert cls(**CPU).device == torch.device("cpu")
    with pytest.raises(RuntimeError):
        tnlp.load_txt_vectors("never-read.txt")
    with pytest.raises(RuntimeError):
        tnlp.read_binary_model("never-read.bin")
    for cls in (tnlp.Word2Vec, tnlp.Glove):
        with pytest.raises(NotImplementedError, match="A7"):
            cls(mesh=object(), **CPU)


def test_empty_vocabulary_and_corpus_errors():
    with pytest.raises(ValueError, match="empty vocabulary"):
        tnlp.Word2Vec(min_word_frequency=5, **CPU).fit(["a b"])
    with pytest.raises(ValueError, match="co-occurrences"):
        tnlp.Glove(**CPU).fit(["a"])
    with pytest.raises(ValueError, match="build vocab"):
        tnlp.Glove(**CPU).partial_fit(["a b"])


# ---- the float32 bounds of the nlp card check (chip_smoke.py) ---------------


def _duplicate_heavy_hs_batch(b=4096, v=300, d=64, path=6):
    """An HS batch whose every pair shares one target's path, with input
    rows of alternating sign along one direction, in an order that adds
    all the positive rows first: the order an atomics schedule may pick,
    and the one where float32 summation drifts most."""
    rng = np.random.default_rng(0)
    points = torch.from_numpy(rng.integers(0, v - 1, (v, path))).long()
    codes = torch.from_numpy(rng.integers(0, 2, (v, path))).long()
    hs = (points, codes, torch.full((v,), path, dtype=torch.long))
    direction = rng.standard_normal(d).astype(np.float32)
    sign = np.where(np.arange(v) % 2 == 0, 1.0, -1.0).astype(np.float32)
    syn0 = torch.from_numpy((sign[:, None] * direction[None, :]
                             + 0.01 * rng.standard_normal((v, d))
                             ).astype(np.float32))
    syn1 = torch.from_numpy(rng.standard_normal((v - 1, d)).astype(
        np.float32) * 1e-3)
    inputs = torch.from_numpy(rng.integers(0, v, b)).long()
    inputs = inputs[torch.argsort(inputs % 2, stable=True)]
    targets = torch.full((b,), 7, dtype=torch.long)
    return hs, syn0, syn1, inputs, targets


def _hs_leg(b=4096):
    """(make(order) -> run, tables, bounds(order)) of the HS batch above."""
    import chip_smoke

    hs, syn0, syn1, inputs, targets = _duplicate_heavy_hs_batch(b=b)

    def make(order):
        def run(t):
            return tw2v.hs_step(t[0], t[1], hs, inputs[order],
                                targets[order], 0.025,
                                torch.ones(b, dtype=t[0].dtype))
        return run

    def bounds(order):
        return chip_smoke.hs_step_bounds([syn0, syn1], hs, inputs[order],
                                         targets[order], 0.025)
    return make, [syn0, syn1], bounds


def _zipf_leg(step, v=400, d=32, b=2048):
    """The same for a NEG or GloVe batch with zipf-skewed duplicate rows."""
    import chip_smoke

    from deeplearning4j_tpu_torch.nlp.glove import glove_step

    rng = np.random.default_rng(3)
    ii = torch.from_numpy(rng.zipf(1.3, b) % v).long()
    jj = torch.from_numpy(rng.integers(0, v, b)).long()
    if step == "neg":
        negs = torch.from_numpy(rng.zipf(1.3, (b, 5)) % v).long()
        tables = [torch.from_numpy(rng.standard_normal((v, d)).astype(
            np.float32) * 0.3) for _ in range(2)]

        def make(order):
            def run(t):
                return tw2v.neg_step(t[0], t[1], ii[order], jj[order],
                                     negs[order], 0.025,
                                     torch.ones(b, dtype=t[0].dtype))
            return run

        def bounds(order):
            return chip_smoke.neg_step_bounds(tables, ii[order], jj[order],
                                              negs[order], 0.025)
        return make, tables, bounds
    xx = torch.from_numpy(rng.random(b).astype(np.float32) * 50 + 0.5)
    tables = [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32) * 0.1) for shape in ((v, d), (v, d), (v,), (v,))]
    tables += [torch.from_numpy(rng.random(tuple(t.shape)).astype(
        np.float32)) for t in tables]

    def make(order):
        def run(t):
            return glove_step(tuple(t[:4]), tuple(t[4:]), ii[order],
                              jj[order], xx[order].to(t[0].dtype),
                              torch.ones(b, dtype=t[0].dtype), 0.05,
                              100.0, 0.75)
        return run

    def bounds(order):
        return chip_smoke.glove_step_bounds(tables, ii[order], jj[order],
                                            xx[order], 0.05, 100.0, 0.75)
    return make, tables, bounds


def _leg(step):
    return _hs_leg() if step == "hs" else _zipf_leg(step)


def _ratios(make, tables, bounds, order, wrong=None):
    """The float32 run in `order` held to the float64 one; `wrong(source)`,
    if given, rewrites the first add's source before the recording sees
    it, as a card computing a wrong update would."""
    import chip_smoke

    run = make(order)
    if wrong is not None:
        inner = run

        def run(t):
            recording = torch.Tensor.index_add_
            first = []

            def rewrite(self, dim, index, source, *, alpha=1):
                if not first:
                    first.append(True)
                    source = wrong(source.clone())
                return recording(self, dim, index, source, alpha=alpha)
            torch.Tensor.index_add_ = rewrite
            try:
                return inner(t)
            finally:
                torch.Tensor.index_add_ = recording
    ref = chip_smoke.recorded_step(make(order), tables, "cpu", "float64")
    got = chip_smoke.recorded_step(run, tables, "cpu", "float32")
    return chip_smoke.scatter_bound_ratio(tables, got, ref, bounds(order)), got


def test_nlp_card_check_bound_holds_where_the_old_rule_failed():
    make, tables, bounds = _hs_leg()
    b = 4096
    results = []
    for seed in (None, 1, 2):
        order = (torch.arange(b) if seed is None else torch.from_numpy(
            np.random.default_rng(seed).permutation(b)))
        ratio, got = _ratios(make, tables, bounds, order)
        assert max(ratio["updates"], ratio["tables"], ratio["loss"]) <= 1.0, \
            ratio
        results.append(got)
    # the old rule: the touched rows of another order within 1e-5 of the
    # in-order run, relative to their largest value; it fails here
    rows = _duplicate_heavy_hs_batch()[0][0][7]
    old = max(float((r["tables"][1][rows] - results[0]["tables"][1][rows])
                    .abs().max() / results[0]["tables"][1][rows].abs().max())
              for r in results[1:])
    assert old > 1e-5


@pytest.mark.parametrize("step", ["neg", "glove"])
def test_nlp_card_check_bound_holds_in_any_order(step):
    make, tables, bounds = _leg(step)
    b = 2048
    for seed in (None, 5):
        order = (torch.arange(b) if seed is None else torch.from_numpy(
            np.random.default_rng(seed).permutation(b)))
        ratio, _ = _ratios(make, tables, bounds, order)
        assert max(ratio["updates"], ratio["tables"], ratio["loss"]) <= 1.0, \
            ratio


@pytest.mark.parametrize("step", ["hs", "neg", "glove"])
def test_nlp_card_check_catches_an_update_off_by_one_percent(step):
    """A card that scales one row of one update by 1.01 (and adds what it
    computed) fails the update check: no bound is measured from the run
    under test."""
    make, tables, bounds = _leg(step)
    b = 4096 if step == "hs" else 2048
    order = torch.arange(b)

    def scaled(source):
        row = int(source.reshape(source.shape[0], -1).abs().sum(1).argmax())
        source[row] *= 1.01
        return source
    ratio, _ = _ratios(make, tables, bounds, order, wrong=scaled)
    assert ratio["updates"] > 1.0, ratio


def test_nlp_card_check_catches_a_doubled_add_and_a_nan():
    """An update added twice fails the table check; a NaN reads as inf."""
    import chip_smoke

    make, tables, bounds = _hs_leg(b=512)
    order = torch.arange(512)
    _, got = _ratios(make, tables, bounds, order)
    ref = chip_smoke.recorded_step(make(order), tables, "cpu", "float64")
    _, rows, d = got["adds"][1]
    got["tables"][1].index_add_(0, rows[:1], d[:1].float())
    assert chip_smoke.scatter_bound_ratio(tables, got, ref,
                                          bounds(order))["tables"] > 1.0
    got["tables"][1][0, 0] = float("nan")
    assert chip_smoke.scatter_bound_ratio(
        tables, got, ref, bounds(order))["tables"] == float("inf")
