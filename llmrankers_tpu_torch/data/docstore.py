"""Document stores and query sources.

The reference fetches passage text from ir_datasets docs_store()
(run.py:165-168) or a Lucene index via Pyserini (run.py:169-173,
run_setwise.py:271-275), and queries from ir_datasets / Pyserini topics /
.tsv / .jsonl files (run.py:135-149, run_setwise.py:247-261). Those
libraries stay optional (gated imports); JSONL/TSV file stores are
first-class so the framework runs self-contained.

Title handling matches the reference: when a title exists it is
prepended as "{title} {text}" (run.py:166-173).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple


class Docstore:
    def get_text(self, docid: str) -> str:
        raise NotImplementedError


class DictDocstore(Docstore):
    def __init__(self, mapping: Dict[str, str]):
        self._m = mapping

    def get_text(self, docid: str) -> str:
        return self._m[docid]


def _row_docid(d: Dict) -> str:
    """Preference order id > docid > _id, by key PRESENCE (not
    truthiness — {"id": 0} must index as "0"). Shared convention with
    the no-parse scanners (utils/native.jsonl_scan)."""
    for k in ("id", "docid", "_id"):
        if k in d:
            return str(d[k])
    raise ValueError("row without an id/docid/_id key")


def _row_text(d: Dict) -> str:
    """text/contents fallback + title prepend (run.py:166-173). One
    definition so the in-memory and offset-indexed stores can never
    disagree."""
    text = d.get("text") or d.get("contents") or ""
    if d.get("title"):
        text = f"{d['title']} {text}"
    return text


class JsonlDocstore(Docstore):
    """{"id"|"docid"|"_id": ..., "title": ..., "text"|"contents": ...} rows.

    Loaded into memory (BM25 top-k corpora are small); an mmap'd offset
    index is unnecessary at reference scale.
    """

    def __init__(self, path: str):
        self._m: Dict[str, str] = {}
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                d = json.loads(line)
                self._m[_row_docid(d)] = _row_text(d)

    def get_text(self, docid: str) -> str:
        return self._m[docid]


class IndexedJsonlDocstore(Docstore):
    """Offset-indexed JSONL store for corpora too large to hold in
    memory (full MS MARCO / BRIGHT stackoverflow; the reference delegates
    these to Lucene, run.py:169-173). One native single-pass scan
    (hostops.cpp::jsonl_scan, regex fallback) builds docid -> (byte
    offset, length); texts parse lazily on access. Memory: the id map
    only (~100B/doc instead of the full text).

    The native scanner locates the id WITHOUT a JSON parse, tracking
    string state and brace depth so only TOP-LEVEL id/docid/_id keys
    are candidates (a nested {"meta": {"id": ...}} never shadows the
    row id — same key semantics as JsonlDocstore). Ids containing JSON
    escapes are unsupported by the offset index."""

    def __init__(self, path: str):
        from ..utils import native

        ids, offs, lens = native.jsonl_scan(path)
        self._index: Dict[str, Tuple[int, int]] = {
            i: (int(o), int(l)) for i, o, l in zip(ids, offs, lens)
        }
        self._path = path
        self._f = open(path, "rb")
        import threading

        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._index)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def get_text(self, docid: str) -> str:
        off, ln = self._index[docid]
        with self._lock:
            self._f.seek(off)
            raw = self._f.read(ln)
        return _row_text(json.loads(raw))


def open_jsonl_docstore(
    path: str, lazy: Optional[bool] = None,
    size_threshold: int = 256 * 1024 * 1024,
) -> Docstore:
    """JSONL docstore with automatic in-memory vs offset-indexed choice:
    files past ``size_threshold`` (or lazy=True) use the indexed store."""
    if lazy is None:
        lazy = os.path.getsize(path) > size_threshold
    return IndexedJsonlDocstore(path) if lazy else JsonlDocstore(path)


class IrDatasetsDocstore(Docstore):
    """ir_datasets-backed store (run.py:165-168); optional dependency."""

    def __init__(self, dataset_name: str):
        import ir_datasets  # gated: not in the base image

        self._store = ir_datasets.load(dataset_name).docs_store()

    def get_text(self, docid: str) -> str:
        doc = self._store.get(docid)
        text = doc.text
        if hasattr(doc, "title"):
            text = f"{doc.title} {text}"
        return text


class PyseriniDocstore(Docstore):
    """Lucene index raw-JSON store (run.py:169-173); optional dependency."""

    def __init__(self, index_name_or_path: str):
        from pyserini.search.lucene import LuceneSearcher  # gated

        if os.path.exists(index_name_or_path):
            self._searcher = LuceneSearcher(index_name_or_path)
        else:
            self._searcher = LuceneSearcher.from_prebuilt_index(index_name_or_path)

    def get_text(self, docid: str) -> str:
        data = json.loads(self._searcher.doc(docid).raw())
        text = data.get("text", "")
        if "title" in data:
            text = f'{data["title"]} {text}'
        return text


# ---------------------------------------------------------------------------
# Query sources
# ---------------------------------------------------------------------------
def load_queries_tsv(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            qid, text = line.rstrip("\n").split("\t", 1)
            out[qid] = text
    return out


def load_queries_jsonl(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            qid = str(d.get("qid") or d.get("query_id") or d.get("id"))
            out[qid] = d.get("query") or d.get("text") or d.get("title")
    return out


def load_queries_ir_datasets(dataset_name: str) -> Dict[str, str]:
    import ir_datasets  # gated

    ds = ir_datasets.load(dataset_name)
    return {q.query_id: q.text for q in ds.queries_iter()}


def load_queries_pyserini_topics(index: str, exact: bool = False) -> Dict[str, str]:
    """Pyserini topics. ``exact`` uses the name as-is (the Rank-R1
    drivers' --pyserini_dataset, run_setwise.py:262-263); otherwise
    '-test' is appended like the reference run.py:149."""
    from pyserini.search._base import get_topics  # gated

    topics = get_topics(index if exact else index + "-test")
    return {str(k): v["title"] for k, v in topics.items()}


def load_queries(path_or_name: str) -> Dict[str, str]:
    """Dispatch on extension: .tsv / .jsonl files, else ir_datasets name."""
    if path_or_name.endswith(".tsv"):
        return load_queries_tsv(path_or_name)
    if path_or_name.endswith(".jsonl"):
        return load_queries_jsonl(path_or_name)
    return load_queries_ir_datasets(path_or_name)
