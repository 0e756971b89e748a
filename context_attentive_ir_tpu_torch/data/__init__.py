"""Host-side data layer of the port: objects, dictionary, vectorizer."""

from .dictionary import Dictionary, build_dictionary
from .objects import Document, Query, Session
from .vectorize import (
    SessionBatch,
    ShapeConfig,
    SuggestBatch,
    build_session_batch,
    build_suggest_batch,
    shapes_from_config,
)

__all__ = [
    "Dictionary", "build_dictionary", "Document", "Query", "Session",
    "SessionBatch", "ShapeConfig", "SuggestBatch", "build_session_batch",
    "build_suggest_batch", "shapes_from_config",
]
