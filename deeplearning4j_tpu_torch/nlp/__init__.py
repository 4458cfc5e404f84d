"""NLP / embedding models (counterpart of `deeplearning4j_tpu.nlp`): the
word-embedding family.

Parity target: reference `deeplearning4j-scaleout/deeplearning4j-nlp` —
Word2Vec (skip-gram, hierarchical softmax + negative sampling), GloVe,
ParagraphVectors, tokenizer/sentence/document iterator SPIs, vocab cache
+ Huffman coding, TF-IDF/BoW vectorizers, the inverted index, moving
windows, the Word2Vec -> DataSet bridge, and word2vec-C-compatible vector
serialization.

Training is dense-batched and deterministic in its host draws: the host
streams integer-encoded pairs (numpy ``default_rng(seed)``, the JAX
package's draws); one step gathers the touched rows on the device,
evaluates the HS/NEG (or GloVe) objective for the whole batch and
scatter-adds the hand-derived updates with ``index_add_``.  The JAX
package wrote no Pallas kernel for this path, so the port's steps are
plain PyTorch ops.  `Word2Vec`, `ParagraphVectors` and `Glove` run on the
card unless the caller passes ``device="cpu"``; `Word2Vec` and `Glove`
take a ``mesh=`` (`parallel.mesh.sparse_allgather_step`).

The sentiment pipeline's front half: the parse trees (`nlp/tree.py`,
host numpy), the annotators (`HmmPosTagger` decoding on the device
Viterbi, `SWN3`, `TreeParser`, `TreeVectorizer`; the tagger runs on the
card unless ``device="cpu"``) and the bundled review corpus
(`nlp/sentiment.py`), which feed `models.RNTN`.

The labelled news corpus (`nlp/news.py`): a directory of label
directories, ``$DL4J_NEWS_DIR``, 20 Newsgroups from the download cache,
or (loudly) a bundled mini corpus, vectorized by TF-IDF or counts.
"""

from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizer,
    DefaultTokenizerFactory,
    EndingPreProcessor,
    InputHomogenization,
    NGramTokenizer,
    NGramTokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
    CollectionSentenceIterator,
    FileSentenceIterator,
    LabelAwareSentenceIterator,
    LineSentenceIterator,
)
from deeplearning4j_tpu_torch.nlp.document_iterator import (
    CollectionDocumentIterator,
    DocumentIterator,
    FileDocumentIterator,
    LabelAwareDocumentIterator,
)
from deeplearning4j_tpu_torch.nlp.annotators import (
    SWN3,
    HmmPosTagger,
    TreeParser,
    TreeVectorizer,
    default_tagger,
)
from deeplearning4j_tpu_torch.nlp.word2vec_iterator import (
    Word2VecDataSetIterator,
)
from deeplearning4j_tpu_torch.nlp.vocab import Huffman, VocabCache, VocabWord
from deeplearning4j_tpu_torch.nlp.word_vectors import WordVectors
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors
from deeplearning4j_tpu_torch.nlp.vectorizers import (
    CountVectorizer,
    TfidfVectorizer,
)
from deeplearning4j_tpu_torch.nlp.serde import (
    load_txt_vectors,
    read_binary_model,
    write_binary_model,
    write_word_vectors,
)
from deeplearning4j_tpu_torch.nlp.tree import (
    Tree,
    compile_trees,
    parse_ptb,
    right_branching,
)
from deeplearning4j_tpu_torch.nlp.news import (
    NewsGroupsDataSetIterator,
    news_corpus,
    news_dataset,
)
from deeplearning4j_tpu_torch.nlp.sentiment import (
    MINI_REVIEWS,
    mini_reviews,
    sentiment_trees,
)

__all__ = [
    "DefaultTokenizer", "NGramTokenizer", "DefaultTokenizerFactory",
    "NGramTokenizerFactory", "EndingPreProcessor", "InputHomogenization",
    "CollectionSentenceIterator", "FileSentenceIterator",
    "LineSentenceIterator", "LabelAwareSentenceIterator",
    "VocabWord", "VocabCache", "Huffman", "WordVectors",
    "Word2Vec", "Glove", "ParagraphVectors",
    "CountVectorizer", "TfidfVectorizer",
    "write_word_vectors", "load_txt_vectors", "write_binary_model",
    "read_binary_model",
    "DocumentIterator", "CollectionDocumentIterator",
    "FileDocumentIterator", "LabelAwareDocumentIterator",
    "Word2VecDataSetIterator",
    "Tree", "parse_ptb", "right_branching", "compile_trees",
    "HmmPosTagger", "SWN3", "TreeParser", "TreeVectorizer",
    "default_tagger", "MINI_REVIEWS", "mini_reviews", "sentiment_trees",
    "news_corpus", "news_dataset", "NewsGroupsDataSetIterator",
]
