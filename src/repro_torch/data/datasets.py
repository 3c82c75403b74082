"""Record workloads: the journal paper's real-dataset evaluation.

A copy of ``repro.data.datasets``, built on the port's own word codec
(``repro_torch.ops.keyspace.encode_words``), so that the port and
``chip_smoke.py`` draw the same records without importing ``repro``.  Four
generator families of structured records ("Engineering In-place Sorting
Algorithms", arXiv 2009.13569), each with its fixed-width word matrix and
an independent numpy sort oracle (``oracle_argsort``):

  SkySurvey     SDSS-like (ra, dec, mag) float32 columns; ra binned to 0.1
                degree, so word 0 is tie-heavy and the tie-break passes run.
  RnaSequences  RNAcentral-like sequences of 8 to 32 letters over ACGU: a
                4-byte word has at most 256 values, so ties last words long.
  UrlPaths      URL strings from a small host and segment vocabulary: long
                shared prefixes, duplicates, proper prefixes.
  TenantTuples  zipf-weighted (tenant, priority, arrival) tuples, the
                multi-tenant scheduler's key; arrival is unique.

Everything is deterministic from ``seed`` and host-side numpy;
``Dataset.words`` is what goes to the card (``ops.sort_records``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.ops import keyspace

__all__ = ["DATASETS", "Dataset", "make_dataset", "oracle_argsort"]


class Dataset(NamedTuple):
    """A generated record workload and its word matrix."""

    name: str
    records: Any          # list[bytes] (strings) or tuple of column arrays
    words: np.ndarray     # (n, W) uint32, word 0 most significant
    spec: keyspace.WordSpec
    payload: np.ndarray   # (n,) int32 row ids


def _sky(rng: np.random.Generator, n: int) -> Tuple[np.ndarray, ...]:
    ra = np.round(rng.uniform(0.0, 360.0, n), 1).astype(np.float32)
    dec = rng.uniform(-90.0, 90.0, n).astype(np.float32)
    mag = np.clip(rng.normal(20.0, 2.0, n), 10.0, 30.0).astype(np.float32)
    return (ra, dec, mag)


_RNA_LETTERS = np.frombuffer(b"ACGU", dtype=np.uint8)


def _rna(rng: np.random.Generator, n: int) -> List[bytes]:
    lens = rng.integers(8, 33, n) if n else np.zeros(0, np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])
    flat = _RNA_LETTERS[rng.integers(0, 4, int(offs[-1]))]
    return [flat[offs[i]: offs[i + 1]].tobytes() for i in range(n)]


_HOSTS = [
    "example.com", "cdn.example.com", "api.example.com", "img.example.com",
    "shop.example.com", "docs.example.com", "m.example.com", "eu.example.com",
]
_SEGMENTS = [
    "v1", "v2", "users", "items", "assets", "img", "static", "data",
    "search", "docs", "a", "b", "42", "7",
]


def _zipf_p(k: int, a: float = 1.2) -> np.ndarray:
    p = 1.0 / np.arange(1, k + 1) ** a
    return p / p.sum()


def _urls(rng: np.random.Generator, n: int) -> List[bytes]:
    hosts = rng.choice(len(_HOSTS), n, p=_zipf_p(len(_HOSTS)))
    depths = rng.integers(0, 4, n)
    segs = rng.choice(len(_SEGMENTS), (n, 3), p=_zipf_p(len(_SEGMENTS)))
    out = []
    for i in range(n):
        path = "".join("/" + _SEGMENTS[s] for s in segs[i, : depths[i]]) or "/"
        out.append(f"https://{_HOSTS[hosts[i]]}{path}".encode())
    return out


def _tenants(rng: np.random.Generator, n: int) -> Tuple[np.ndarray, ...]:
    tenant = rng.choice(1024, n, p=_zipf_p(1024)).astype(np.uint32)
    priority = rng.integers(0, 8, n).astype(np.uint8)
    arrival = rng.permutation(n).astype(np.uint32)  # unique: no full-row ties
    return (tenant, priority, arrival)


DATASETS: Dict[str, Callable[[np.random.Generator, int], Any]] = {
    "SkySurvey": _sky,
    "RnaSequences": _rna,
    "UrlPaths": _urls,
    "TenantTuples": _tenants,
}


def make_dataset(name: str, n: int, seed: int = 0, width: Optional[int] = None) -> Dataset:
    """Dataset ``name`` with ``n`` records, deterministic from ``seed``.
    ``width`` clips string records to a byte budget (fewer words, heavier
    ties); composite-column families ignore it."""
    records = DATASETS[name](np.random.default_rng(seed), n)
    if isinstance(records, list) and width is not None:
        records = [r[:width] for r in records]
        words, spec = keyspace.encode_words(records, width=width)
    else:
        words, spec = keyspace.encode_words(records)
    return Dataset(name=name, records=records, words=words, spec=spec,
                   payload=np.arange(n, dtype=np.int32))


def oracle_argsort(ds: Dataset) -> np.ndarray:
    """The stable sort order of the dataset's records, computed without the
    word encoding: a byte-string argsort for strings, ``np.lexsort`` over
    the raw columns for composite records (the generators emit no NaN and
    no -0.0, where IEEE and keyspace order differ).
    ``ops.argsort_records(ds.words)`` must equal it."""
    if ds.spec.kind == "bytes":
        maxlen = max((len(r) for r in ds.records), default=0)
        arr = np.array(ds.records, dtype=f"S{max(1, maxlen)}")
        return np.argsort(arr, kind="stable")
    return np.lexsort(tuple(reversed(ds.records)))
