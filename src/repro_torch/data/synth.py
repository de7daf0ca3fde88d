"""Synthetic datasets mirroring the paper's evaluation data (counterpart of
`repro.data.synth`; the same seeds give the same tables).

* `sessions_table` — the Conviva-like media-access log (§2.3/§6.1).
* `lineitem_table` — a TPC-H-lite lineitem fact table (§6.1).
* `zipf_codes` — bounded-support Zipf sampler used by both.
"""
from __future__ import annotations

import numpy as np


def zipf_codes(rng: np.random.Generator, n: int, cardinality: int,
               s: float = 1.2) -> np.ndarray:
    """Zipf(s) over a fixed dictionary [0, cardinality)."""
    ranks = np.arange(1, cardinality + 1, dtype=np.float64)
    p = ranks ** -s
    p /= p.sum()
    return rng.choice(cardinality, size=n, p=p).astype(np.int32)


def sessions_table(n_rows: int = 200_000, seed: int = 0,
                   n_cities: int = 200, n_urls: int = 500, n_os: int = 6,
                   n_genres: int = 12, n_days: int = 30,
                   city_s: float = 1.4, url_s: float = 1.2) -> dict[str, np.ndarray]:
    """Conviva-like Sessions fact table. City/URL heavy-tailed; Genre
    near-uniform; SessionTime depends on OS+City."""
    rng = np.random.default_rng(seed)
    city = zipf_codes(rng, n_rows, n_cities, city_s)
    url = zipf_codes(rng, n_rows, n_urls, url_s)
    os_ = rng.choice(n_os, size=n_rows,
                     p=_normalize(np.array([0.4, 0.25, 0.15, 0.1, 0.07, 0.03][:n_os]))).astype(np.int32)
    genre = rng.integers(0, n_genres, size=n_rows).astype(np.int32)  # uniform
    dt = rng.integers(0, n_days, size=n_rows).astype(np.int32)
    base = 20.0 + 3.0 * (os_ % 3) + 0.05 * (city % 17)
    session_time = rng.gamma(shape=2.0, scale=base / 2.0).astype(np.float32)
    bitrate = (800 + 100 * (os_ % 4) + rng.normal(0, 60, n_rows)).astype(np.float32)
    return {
        "City": _label("city", city), "URL": _label("url", url),
        "OS": _label("os", os_), "Genre": _label("genre", genre),
        "dt": dt.astype(np.int32),
        "SessionTime": session_time, "Bitrate": bitrate,
    }


def lineitem_table(n_rows: int = 200_000, seed: int = 1) -> dict[str, np.ndarray]:
    """TPC-H-lite lineitem: skewed suppkey/partkey, uniform returnflag."""
    rng = np.random.default_rng(seed)
    suppkey = zipf_codes(rng, n_rows, 1000, 1.3)
    partkey = zipf_codes(rng, n_rows, 2000, 1.1)
    shipmode = rng.integers(0, 7, n_rows).astype(np.int32)
    returnflag = rng.integers(0, 3, n_rows).astype(np.int32)
    linestatus = rng.integers(0, 2, n_rows).astype(np.int32)
    quantity = rng.integers(1, 51, n_rows).astype(np.float32)
    extendedprice = (quantity * rng.uniform(900, 1100, n_rows)).astype(np.float32)
    discount = rng.uniform(0, 0.1, n_rows).astype(np.float32)
    return {
        "l_suppkey": _label("s", suppkey), "l_partkey": _label("p", partkey),
        "l_shipmode": _label("mode", shipmode),
        "l_returnflag": _label("rf", returnflag),
        "l_linestatus": _label("ls", linestatus),
        "l_quantity": quantity, "l_extendedprice": extendedprice,
        "l_discount": discount,
    }


def _label(prefix: str, codes: np.ndarray) -> np.ndarray:
    """Decode int codes to string labels (exercises dictionary encoding).
    Builds each label once per code and indexes: every label of one call
    has the same width, so the result equals the per-row construction."""
    if not codes.size:
        return np.array([])
    width = len(str(codes.max()))
    labels = np.array([f"{prefix}{c:0{width}d}"
                       for c in range(int(codes.max()) + 1)])
    return labels[codes]


def _normalize(p: np.ndarray) -> np.ndarray:
    return p / p.sum()
