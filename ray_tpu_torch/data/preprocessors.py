"""Preprocessors: fit/transform over Datastreams.

Capability parity with the reference's `python/ray/data/preprocessors/`
(scalers, encoders, chain, batch mapper, concatenator). Fit statistics are
computed with distributed column reductions; transform is a lazy
`map_batches` so it fuses into the block tasks.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.datastream import Datastream, _block_rows


class Preprocessor:
    """fit(ds) learns state; transform(ds) applies it lazily."""

    _fitted = False

    def fit(self, ds: Datastream) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def transform(self, ds: Datastream) -> Datastream:
        if not self._fitted and self._needs_fit():
            raise RuntimeError(f"{type(self).__name__} must be fit first")
        fn = self._transform_batch
        return ds.map_batches(lambda b: fn(_as_columns(b)))

    def fit_transform(self, ds: Datastream) -> Datastream:
        return self.fit(ds).transform(ds)

    def transform_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self._transform_batch(_as_columns(batch))

    # -- subclass hooks
    def _needs_fit(self) -> bool:
        return True

    def _fit(self, ds: Datastream) -> None:
        pass

    def _transform_batch(self, batch):
        raise NotImplementedError


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (reference `preprocessors/scaler.py`)."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats: Dict[str, tuple] = {}

    def _fit(self, ds: Datastream) -> None:
        for c in self.columns:
            self.stats[c] = (ds.mean(c), ds.std(c, ddof=0) or 1.0)

    def _transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            mean, std = self.stats[c]
            out[c] = (np.asarray(batch[c], dtype=np.float64) - mean) / (std or 1.0)
        return out


class MinMaxScaler(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats: Dict[str, tuple] = {}

    def _fit(self, ds: Datastream) -> None:
        for c in self.columns:
            lo, hi = ds.min(c), ds.max(c)
            self.stats[c] = (float(lo), float(hi))

    def _transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            lo, hi = self.stats[c]
            rng = (hi - lo) or 1.0
            out[c] = (np.asarray(batch[c], dtype=np.float64) - lo) / rng
        return out


class LabelEncoder(Preprocessor):
    def __init__(self, label_column: str):
        self.column = label_column
        self.classes: List[Any] = []

    def _fit(self, ds: Datastream) -> None:
        self.classes = ds.unique(self.column)
        self._index = {c: i for i, c in enumerate(self.classes)}

    def _transform_batch(self, batch):
        out = dict(batch)
        out[self.column] = np.asarray(
            [self._index[v.item() if hasattr(v, "item") else v]
             for v in np.atleast_1d(batch[self.column])])
        return out


class OneHotEncoder(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.classes: Dict[str, List[Any]] = {}

    def _fit(self, ds: Datastream) -> None:
        for c in self.columns:
            self.classes[c] = ds.unique(c)

    def _transform_batch(self, batch):
        out = {k: v for k, v in batch.items() if k not in self.columns}
        for c in self.columns:
            vals = np.atleast_1d(batch[c])
            for cls in self.classes[c]:
                out[f"{c}_{cls}"] = (vals == cls).astype(np.int64)
        return out


class Concatenator(Preprocessor):
    """Pack feature columns into one float matrix column (the layout
    `iter_torch_batches` feeds straight to the card)."""

    def __init__(self, include: Optional[List[str]] = None,
                 exclude: Optional[List[str]] = None,
                 output_column_name: str = "concat_out",
                 dtype=np.float32):
        self.include = include
        self.exclude = set(exclude or [])
        self.out = output_column_name
        self.dtype = dtype

    def _needs_fit(self) -> bool:
        return False

    def _transform_batch(self, batch):
        cols = self.include or [k for k in batch if k not in self.exclude]
        mats = [np.asarray(batch[c], dtype=self.dtype).reshape(len(batch[c]), -1)
                for c in cols]
        out = {k: v for k, v in batch.items() if k not in cols}
        out[self.out] = np.concatenate(mats, axis=1)
        return out


class BatchMapper(Preprocessor):
    def __init__(self, fn: Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]):
        self.fn = fn

    def _needs_fit(self) -> bool:
        return False

    def _transform_batch(self, batch):
        return self.fn(batch)


class Chain(Preprocessor):
    def __init__(self, *preprocessors: Preprocessor):
        self.stages = list(preprocessors)

    def fit(self, ds: Datastream) -> "Chain":
        for i, p in enumerate(self.stages):
            p.fit(ds)
            ds = p.transform(ds)
        self._fitted = True
        return self

    def transform(self, ds: Datastream) -> Datastream:
        for p in self.stages:
            ds = p.transform(ds)
        return ds

    def _transform_batch(self, batch):
        for p in self.stages:
            batch = p._transform_batch(batch)
        return batch


def _column_values(ds: Datastream, column: str) -> np.ndarray:
    """Gather one column to the driver for fit statistics that need the
    full distribution (quantiles, vocabularies). Extraction runs remotely
    per block (Datastream._column_values) — only the named column crosses
    the wire."""
    parts = [np.atleast_1d(v) for v in ds._column_values(column)
             if len(np.atleast_1d(v))]
    return np.concatenate(parts) if parts else np.array([])


class MaxAbsScaler(Preprocessor):
    """x / max|x| per column (reference `preprocessors/scaler.py:181`)."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats: Dict[str, float] = {}

    def _fit(self, ds: Datastream) -> None:
        for c in self.columns:
            self.stats[c] = float(max(abs(ds.min(c)), abs(ds.max(c)))) or 1.0

    def _transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            out[c] = np.asarray(batch[c], dtype=np.float64) / self.stats[c]
        return out


class RobustScaler(Preprocessor):
    """(x - median) / IQR per column — outlier-insensitive scaling
    (reference `preprocessors/scaler.py` RobustScaler)."""

    def __init__(self, columns: List[str],
                 quantile_range: tuple = (0.25, 0.75)):
        self.columns = list(columns)
        self.quantile_range = quantile_range
        self.stats: Dict[str, tuple] = {}

    def _fit(self, ds: Datastream) -> None:
        lo_q, hi_q = self.quantile_range
        for c in self.columns:
            vals = _column_values(ds, c).astype(np.float64)
            med = float(np.median(vals))
            lo, hi = np.quantile(vals, [lo_q, hi_q])
            self.stats[c] = (med, float(hi - lo) or 1.0)

    def _transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            med, iqr = self.stats[c]
            out[c] = (np.asarray(batch[c], dtype=np.float64) - med) / iqr
        return out


class SimpleImputer(Preprocessor):
    """Fill missing values (NaN; None for object columns) with the fitted
    mean/median/most_frequent or a constant (reference
    `preprocessors/imputer.py`)."""

    def __init__(self, columns: List[str], strategy: str = "mean",
                 fill_value: Any = None):
        if strategy not in ("mean", "median", "most_frequent", "constant"):
            raise ValueError(f"unknown strategy {strategy!r}")
        if strategy == "constant" and fill_value is None:
            raise ValueError("strategy='constant' needs fill_value")
        self.columns = list(columns)
        self.strategy = strategy
        self.fill_value = fill_value
        self.stats: Dict[str, Any] = {}

    def _needs_fit(self) -> bool:
        return self.strategy != "constant"

    def _fit(self, ds: Datastream) -> None:
        for c in self.columns:
            vals = _column_values(ds, c)
            if self.strategy == "most_frequent":
                items, counts = np.unique(
                    vals[~_missing_mask(vals)], return_counts=True)
                self.stats[c] = items[np.argmax(counts)]
                continue
            clean = vals[~_missing_mask(vals)].astype(np.float64)
            self.stats[c] = (float(np.mean(clean)) if self.strategy == "mean"
                             else float(np.median(clean)))

    def _transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            vals = np.atleast_1d(batch[c])
            fill = (self.fill_value if self.strategy == "constant"
                    else self.stats[c])
            mask = _missing_mask(vals)
            if mask.any():
                vals = vals.copy()
                vals[mask] = fill
            out[c] = vals
        return out


def _as_columns(batch) -> Dict[str, np.ndarray]:
    """Row blocks (list-of-dicts with list-valued fields, e.g. from_items)
    columnarize to object arrays so every preprocessor sees one layout."""
    if isinstance(batch, dict):
        return batch
    rows = _block_rows(batch)
    if not (rows and isinstance(rows[0], dict)):
        return batch  # scalar rows: nothing columnar to offer
    out: Dict[str, np.ndarray] = {}
    for k in rows[0]:
        col = np.empty(len(rows), dtype=object)
        for i, r in enumerate(rows):
            col[i] = r.get(k)
        out[k] = col
    return out


def _missing_mask(vals: np.ndarray) -> np.ndarray:
    if vals.dtype.kind == "f":
        return np.isnan(vals)
    if vals.dtype == object:
        return np.asarray([v is None or (isinstance(v, float) and np.isnan(v))
                           for v in vals])
    return np.zeros(len(vals), dtype=bool)


class Normalizer(Preprocessor):
    """Row-wise normalization to unit l1/l2/max norm over a column group
    (reference `preprocessors/normalizer.py`)."""

    def __init__(self, columns: List[str], norm: str = "l2"):
        if norm not in ("l1", "l2", "max"):
            raise ValueError(f"unknown norm {norm!r}")
        self.columns = list(columns)
        self.norm = norm

    def _needs_fit(self) -> bool:
        return False

    def _transform_batch(self, batch):
        mat = np.stack([np.asarray(batch[c], dtype=np.float64)
                        for c in self.columns], axis=1)
        if self.norm == "l1":
            denom = np.abs(mat).sum(axis=1)
        elif self.norm == "l2":
            denom = np.sqrt((mat * mat).sum(axis=1))
        else:
            denom = np.abs(mat).max(axis=1)
        denom = np.where(denom == 0, 1.0, denom)
        out = dict(batch)
        for i, c in enumerate(self.columns):
            out[c] = mat[:, i] / denom
        return out


class PowerTransformer(Preprocessor):
    """Yeo-Johnson / Box-Cox power transform with a caller-chosen power
    (reference `preprocessors/transformer.py:43` — the reference also
    takes the power as a parameter rather than fitting it)."""

    def __init__(self, columns: List[str], power: float,
                 method: str = "yeo-johnson"):
        if method not in ("yeo-johnson", "box-cox"):
            raise ValueError(f"unknown method {method!r}")
        self.columns = list(columns)
        self.power = power
        self.method = method

    def _needs_fit(self) -> bool:
        return False

    def _transform_batch(self, batch):
        out = dict(batch)
        p = self.power
        for c in self.columns:
            x = np.asarray(batch[c], dtype=np.float64)
            if self.method == "box-cox":
                out[c] = np.log(x) if p == 0 else (np.power(x, p) - 1) / p
                continue
            pos = x >= 0
            r = np.empty_like(x)
            r[pos] = (np.log1p(x[pos]) if p == 0
                      else (np.power(x[pos] + 1, p) - 1) / p)
            r[~pos] = (-np.log1p(-x[~pos]) if p == 2
                       else -(np.power(1 - x[~pos], 2 - p) - 1) / (2 - p))
            out[c] = r
        return out


class OrdinalEncoder(Preprocessor):
    """Category -> integer index per column (reference
    `preprocessors/encoder.py` OrdinalEncoder)."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.index: Dict[str, Dict[Any, int]] = {}

    def _fit(self, ds: Datastream) -> None:
        for c in self.columns:
            self.index[c] = {v: i for i, v in enumerate(ds.unique(c))}

    def _transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            idx = self.index[c]
            out[c] = np.asarray(
                [idx[v.item() if hasattr(v, "item") else v]
                 for v in np.atleast_1d(batch[c])], dtype=np.int64)
        return out


class MultiHotEncoder(Preprocessor):
    """List-valued column -> fixed multi-hot vector (reference
    `preprocessors/encoder.py` MultiHotEncoder): pairs with the arrow
    ingestion that keeps var-length list columns as per-row arrays."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.classes: Dict[str, List[Any]] = {}

    def _fit(self, ds: Datastream) -> None:
        for c in self.columns:
            seen = set()
            for row_list in _column_values(ds, c):
                seen.update(np.asarray(row_list).tolist())
            self.classes[c] = sorted(seen)

    def _transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            idx = {v: i for i, v in enumerate(self.classes[c])}
            rows = np.atleast_1d(batch[c])
            mat = np.zeros((len(rows), len(idx)), dtype=np.int64)
            for i, row_list in enumerate(rows):
                for v in np.asarray(row_list).tolist():
                    if v in idx:
                        mat[i, idx[v]] = 1
            out[c] = mat
        return out


class KBinsDiscretizer(Preprocessor):
    """Continuous column -> integer bin ids, uniform or quantile edges
    (reference `preprocessors/discretizer.py` Uniform/CustomKBins)."""

    def __init__(self, columns: List[str], bins: int = 5,
                 strategy: str = "uniform"):
        if strategy not in ("uniform", "quantile"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.columns = list(columns)
        self.bins = bins
        self.strategy = strategy
        self.edges: Dict[str, np.ndarray] = {}

    def _fit(self, ds: Datastream) -> None:
        for c in self.columns:
            if self.strategy == "uniform":
                lo, hi = float(ds.min(c)), float(ds.max(c))
                self.edges[c] = np.linspace(lo, hi, self.bins + 1)[1:-1]
            else:
                vals = _column_values(ds, c).astype(np.float64)
                qs = np.linspace(0, 1, self.bins + 1)[1:-1]
                self.edges[c] = np.quantile(vals, qs)

    def _transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            out[c] = np.digitize(
                np.asarray(batch[c], dtype=np.float64), self.edges[c])
        return out


class Tokenizer(Preprocessor):
    """String column -> list-of-tokens column (reference
    `preprocessors/tokenizer.py`; default whitespace split)."""

    def __init__(self, columns: List[str],
                 tokenization_fn: Optional[Callable[[str], List[str]]] = None):
        self.columns = list(columns)
        self.fn = tokenization_fn or (lambda s: str(s).split())

    def _needs_fit(self) -> bool:
        return False

    def _transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            toks = np.empty(len(np.atleast_1d(batch[c])), dtype=object)
            for i, s in enumerate(np.atleast_1d(batch[c])):
                toks[i] = self.fn(s)
            out[c] = toks
        return out


class CountVectorizer(Preprocessor):
    """Token counts over a fitted vocabulary, one count column per token
    (reference `preprocessors/vectorizer.py` CountVectorizer)."""

    def __init__(self, columns: List[str],
                 tokenization_fn: Optional[Callable[[str], List[str]]] = None,
                 max_features: Optional[int] = None):
        self.columns = list(columns)
        self.fn = tokenization_fn or (lambda s: str(s).split())
        self.max_features = max_features
        self.vocab: Dict[str, List[str]] = {}

    def _fit(self, ds: Datastream) -> None:
        from collections import Counter

        for c in self.columns:
            counts: Counter = Counter()
            for s in _column_values(ds, c):
                counts.update(self.fn(s))
            items = counts.most_common(self.max_features)
            self.vocab[c] = sorted(tok for tok, _ in items)

    def _transform_batch(self, batch):
        out = {k: v for k, v in batch.items() if k not in self.columns}
        for c in self.columns:
            vocab = self.vocab[c]
            idx = {t: i for i, t in enumerate(vocab)}
            rows = np.atleast_1d(batch[c])
            mat = np.zeros((len(rows), len(vocab)), dtype=np.int64)
            for i, s in enumerate(rows):
                for tok in self.fn(s):
                    j = idx.get(tok)
                    if j is not None:
                        mat[i, j] += 1
            for j, tok in enumerate(vocab):
                out[f"{c}_{tok}"] = mat[:, j]
        return out


class FeatureHasher(Preprocessor):
    """Token -> fixed-width hashed count features, vocabulary-free
    (reference `preprocessors/hasher.py`)."""

    def __init__(self, columns: List[str], num_features: int,
                 output_column_name: str = "hashed_features"):
        self.columns = list(columns)
        self.num_features = num_features
        self.out = output_column_name

    def _needs_fit(self) -> bool:
        return False

    def _transform_batch(self, batch):
        import zlib

        rows = len(np.atleast_1d(batch[self.columns[0]]))
        mat = np.zeros((rows, self.num_features), dtype=np.int64)
        for c in self.columns:
            for i, v in enumerate(np.atleast_1d(batch[c])):
                toks = v if isinstance(v, (list, np.ndarray)) else [v]
                for t in np.asarray(toks).tolist():
                    h = zlib.crc32(str(t).encode()) % self.num_features
                    mat[i, h] += 1
        out = {k: v for k, v in batch.items() if k not in self.columns}
        out[self.out] = mat
        return out
