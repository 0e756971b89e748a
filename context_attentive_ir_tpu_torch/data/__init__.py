"""Host-side data layer of the port: objects, dictionary, loaders, the
synthetic fixtures, the vectorizer, the batch iterators, the packed /
prefetching input pipeline and the BM25 slates."""

from .bm25 import BM25Index
from .dataset import BatchIterator, BucketedIterator
from .dictionary import CharDictionary, Dictionary, build_dictionary
from .loader import load_data, load_embedding_words, load_embeddings
from .objects import Document, Query, Session
from .pipeline import PackedBucketedIterator, PackedIterator, prefetch
from .synthetic import (
    ambiguous_vocab,
    generate_ambiguous_sessions,
    generate_sessions,
    generate_suggestion_sessions,
    write_ambiguous_fixture,
    write_fixture,
    write_glove_fixture,
    write_suggestion_fixture,
)
from .vectorize import (
    RankBatch,
    SessionBatch,
    ShapeConfig,
    SuggestBatch,
    build_rank_batch,
    build_session_batch,
    build_suggest_batch,
    rank_examples,
    shapes_from_config,
    suggest_examples,
)

__all__ = [
    "BM25Index", "BatchIterator", "BucketedIterator", "CharDictionary", "Dictionary",
    "build_dictionary",
    "load_data", "load_embedding_words", "load_embeddings", "Document",
    "Query", "Session", "PackedBucketedIterator", "PackedIterator",
    "prefetch", "ambiguous_vocab", "generate_ambiguous_sessions",
    "generate_sessions", "generate_suggestion_sessions",
    "write_ambiguous_fixture", "write_fixture", "write_glove_fixture",
    "write_suggestion_fixture", "RankBatch", "SessionBatch", "ShapeConfig",
    "SuggestBatch", "build_rank_batch", "build_session_batch",
    "build_suggest_batch", "rank_examples", "shapes_from_config",
    "suggest_examples",
]
