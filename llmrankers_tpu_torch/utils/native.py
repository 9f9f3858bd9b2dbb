"""ctypes binding for the native host-ops library (native/hostops.cpp).

Auto-builds ``native/libhostops.so`` on first use when a compiler is
available; every entry point has a numpy fallback so the package works
without the native library.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libhostops.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO_PATH) and os.path.exists(
        os.path.join(_NATIVE_DIR, "Makefile")
    ):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "-s"], check=True,
                capture_output=True, timeout=120,
            )
        except Exception:
            return None
    if not os.path.exists(_SO_PATH):
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.pack_padded.argtypes = [
        i32p, i64p, ctypes.c_int64, i32p, i32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int,
    ]
    lib.byte_encode_batch.argtypes = [
        u8p, i64p, ctypes.c_int64, i32p, i32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ]
    lib.trec_count.argtypes = [ctypes.c_char_p]
    lib.trec_count.restype = ctypes.c_int64
    lib.trec_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        i64p, i64p, i32p, f64p,
    ]
    lib.trec_parse.restype = ctypes.c_int64
    lib.jsonl_count.argtypes = [ctypes.c_char_p]
    lib.jsonl_count.restype = ctypes.c_int64
    lib.jsonl_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, i64p, i64p,
        ctypes.c_char_p, ctypes.c_int64, i64p,
    ]
    lib.jsonl_scan.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _as_i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _as_i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def pack_padded(
    rows: List[List[int]], B: int, L: int, pad_id: int, left_pad: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """Token rows -> padded [B, L] (ids, mask)."""
    lib = _load()
    ids = np.empty((B, L), np.int32)
    mask = np.empty((B, L), np.int32)
    if lib is not None:
        flat = np.fromiter(
            (t for r in rows for t in r), np.int32,
            count=sum(len(r) for r in rows),
        )
        offs = np.zeros(len(rows) + 1, np.int64)
        np.cumsum([len(r) for r in rows], out=offs[1:])
        lib.pack_padded(
            _as_i32p(flat), _as_i64p(offs), len(rows),
            _as_i32p(ids), _as_i32p(mask), B, L, pad_id, int(left_pad),
        )
        return ids, mask
    # numpy fallback
    ids.fill(pad_id)
    mask.fill(0)
    for i, r in enumerate(rows):
        r = r[-L:] if left_pad else r[:L]
        if left_pad:
            ids[i, L - len(r):] = r
            mask[i, L - len(r):] = 1
        else:
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
    return ids, mask


def trec_parse(path: str):
    """Parse a TREC run into (qids, docids, ranks, scores) columns, or
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = lib.trec_count(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    if n == 0:
        return [], [], np.zeros(0, np.int32), np.zeros(0)
    cap = os.path.getsize(path) + 2 * n + 16
    strbuf = ctypes.create_string_buffer(cap)
    qid_off = np.empty(n, np.int64)
    docid_off = np.empty(n, np.int64)
    ranks = np.empty(n, np.int32)
    scores = np.empty(n, np.float64)
    got = lib.trec_parse(
        path.encode(), n, strbuf, cap,
        _as_i64p(qid_off), _as_i64p(docid_off),
        _as_i32p(ranks),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if got < 0:
        raise RuntimeError(f"trec_parse failed with {got}")
    raw = strbuf.raw
    qids = [
        raw[o : raw.index(b"\0", o)].decode() for o in qid_off[:got]
    ]
    docids = [
        raw[o : raw.index(b"\0", o)].decode() for o in docid_off[:got]
    ]
    return qids, docids, ranks[:got], scores[:got]


def jsonl_scan(path: str):
    """Offset-index a JSONL corpus: returns (ids, line_off, line_len)
    where ids[i] is the document id of the non-empty line at byte range
    [line_off[i], line_off[i]+line_len[i]). The id is the value of the
    best TOP-LEVEL key among "id" > "docid" > "_id" (JsonlDocstore's
    preference order); nested objects' keys never shadow the row id.
    Native single-pass depth-tracking scan (no JSON parse); json.loads
    fallback when the library is unavailable."""
    lib = _load()
    if lib is not None:
        n = lib.jsonl_count(path.encode())
        if n < 0:
            raise FileNotFoundError(path)
        if n == 0:
            return [], np.zeros(0, np.int64), np.zeros(0, np.int64)
        line_off = np.empty(n, np.int64)
        line_len = np.empty(n, np.int64)
        id_off = np.empty(n, np.int64)
        cap = 64 * n + 64
        while True:
            idbuf = ctypes.create_string_buffer(cap)
            got = lib.jsonl_scan(
                path.encode(), n, _as_i64p(line_off), _as_i64p(line_len),
                idbuf, cap, _as_i64p(id_off),
            )
            if got == -2:  # ids longer than budgeted: grow and retry
                cap *= 4
                continue
            break
        if got == -3:
            raise ValueError(f"{path}: row without an id/docid/_id key")
        if got < 0:
            raise RuntimeError(f"jsonl_scan failed with {got}")
        raw = idbuf.raw
        ids = [raw[o: raw.index(b"\0", o)].decode() for o in id_off[:got]]
        return ids, line_off[:got], line_len[:got]
    # pure-Python fallback: json.loads per line — slower than the native
    # scanner but byte-for-byte consistent with JsonlDocstore's key
    # preference (top-level only; a nested {"meta": {"id": ...}} can
    # never shadow the row id).
    import json

    ids: List[str] = []
    offs: List[int] = []
    lens: List[int] = []
    off = 0
    with open(path, "rb") as f:
        for line in f:
            if line.strip():
                d = json.loads(line)
                row_id = next(
                    (d[k] for k in ("id", "docid", "_id") if k in d), None
                )
                if row_id is None:
                    raise ValueError(
                        f"{path}: row without an id/docid/_id key"
                    )
                ids.append(str(row_id))
                offs.append(off)
                lens.append(len(line))
            off += len(line)
    return ids, np.asarray(offs, np.int64), np.asarray(lens, np.int64)
