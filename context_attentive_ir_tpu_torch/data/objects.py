"""Domain objects: Query, Document, Session.

Parity target: ``neuroir/objects/{query,document,session}.py`` (SURVEY.md
SS2.2, marker ``exp:``).  These are host-side containers parsed from the
JSON-lines session files; device code only ever sees the static-shape id
tensors built from them by ``data/vectorize.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Document:
    """A candidate document: id, title tokens, binary click/relevance label."""

    doc_id: str
    tokens: list[str]
    label: int = 0  # 1 = clicked / relevant

    @classmethod
    def from_dict(cls, d: dict) -> "Document":
        tokens = d.get("tokens")
        if tokens is None:
            tokens = str(d.get("title", "")).split()
        return cls(doc_id=str(d.get("id", "")), tokens=list(tokens),
                   label=int(d.get("label", 0)))


@dataclass
class Query:
    """A query in a session, with its candidate slate."""

    query_id: str
    tokens: list[str]
    documents: list[Document] = field(default_factory=list)

    @property
    def text(self) -> str:
        return " ".join(self.tokens)

    @classmethod
    def from_dict(cls, d: dict) -> "Query":
        tokens = d.get("tokens")
        if tokens is None:
            tokens = str(d.get("text", "")).split()
        docs = [Document.from_dict(c) for c in d.get("candidates", [])]
        return cls(query_id=str(d.get("id", "")), tokens=list(tokens),
                   documents=docs)


@dataclass
class Session:
    """An ordered list of queries issued by one user in one session.

    Iteration yields training views ``(context_queries, current_query,
    next_query_or_None)`` mirroring the reference Session's role of exposing
    (context, current, slate, next) tuples (SURVEY.md SS2.2).
    """

    session_id: str
    queries: list[Query] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.queries)

    def views(self):
        for t, q in enumerate(self.queries):
            nxt = self.queries[t + 1] if t + 1 < len(self.queries) else None
            yield self.queries[:t], q, nxt

    @classmethod
    def from_dict(cls, d: dict) -> "Session":
        qs = [Query.from_dict(q) for q in d.get("query", d.get("queries", []))]
        return cls(session_id=str(d.get("session_id", "")), queries=qs)
