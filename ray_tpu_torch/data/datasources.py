"""Extended datasources: images, SQL, WebDataset, mongo.

Reference parity: python/ray/data/datasource/{image_datasource.py,
sql_datasource.py, webdataset_datasource.py, mongo_datasource.py}. Each
reader fans file/shard loading out as one task per input, like the rest of
ray_tpu_torch.data (datastream.py read_* constructors).
"""

from __future__ import annotations

import builtins
import os
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.datastream import Block, Datastream, _block_rows, _rows_to_block

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tiff", ".webp")


def _expand_paths(paths: Union[str, List[str]], exts=None) -> List[str]:
    paths = [paths] if isinstance(paths, str) else list(paths)
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for name in sorted(os.listdir(p)):
                full = os.path.join(p, name)
                if os.path.isfile(full) and (
                        exts is None or name.lower().endswith(exts)):
                    out.append(full)
        else:
            out.append(p)
    return out


def read_images(paths: Union[str, List[str]], *,
                size: Optional[tuple] = None,
                mode: Optional[str] = None,
                include_paths: bool = False) -> Datastream:
    """Decode image files into HWC uint8 arrays (column "image").

    `size=(h, w)` resizes; `mode` converts colorspace ("RGB", "L", ...).
    Mirrors reference ImageDatasource options.
    """
    files = _expand_paths(paths, _IMAGE_EXTS)

    @ray_tpu_torch.remote
    def load(path: str) -> Block:
        from PIL import Image

        img = Image.open(path)
        if mode is not None:
            img = img.convert(mode)
        if size is not None:
            img = img.resize((size[1], size[0]))
        row: Dict[str, Any] = {"image": np.asarray(img)}
        if include_paths:
            row["path"] = path
        return [row]

    return Datastream([load.remote(p) for p in files])


def read_sql(sql: str, connection_factory: Callable[[], Any], *,
             parallelism: int = 1,
             shard_column: Optional[str] = None) -> Datastream:
    """Run a SQL query through a DB-API connection factory.

    With `shard_column` + `parallelism>1`, issues one modular-hash-sharded
    query per task (the reference shards on an integer key the same way);
    otherwise a single task runs the query as-is.
    """
    def fetch(query: str) -> Block:
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(query)
            cols = [d[0] for d in cur.description]
            return _rows_to_block(
                [dict(zip(cols, row)) for row in cur.fetchall()])
        finally:
            conn.close()

    remote_fetch = ray_tpu_torch.remote(fetch)
    if shard_column and parallelism > 1:
        # normalize negatives ((x % n + n) % n) and NULLs (shard 0) so no
        # row can fall outside every shard
        c, n = shard_column, parallelism
        shard_expr = f"COALESCE((({c} % {n}) + {n}) % {n}, 0)"
        queries = [
            f"SELECT * FROM ({sql}) AS _rt_shard WHERE {shard_expr} = {i}"
            for i in builtins.range(parallelism)]
    else:
        queries = [sql]
    return Datastream([remote_fetch.remote(q) for q in queries])


def _decode_wds_member(name: str, data: bytes) -> Any:
    ext = name.rsplit(".", 1)[-1].lower()
    if ext in ("jpg", "jpeg", "png", "bmp", "gif", "webp"):
        import io

        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(data)))
    if ext in ("json",):
        import json

        return json.loads(data)
    if ext in ("txt", "text", "cls", "cls2"):
        text = data.decode()
        return int(text) if ext.startswith("cls") else text
    if ext in ("npy",):
        import io

        return np.load(io.BytesIO(data))
    return data


def read_webdataset(paths: Union[str, List[str]], *,
                    decode: bool = True) -> Datastream:
    """WebDataset tar shards: members grouped by key prefix, one row per
    sample with a column per extension (reference webdataset_datasource.py).
    """
    shards = _expand_paths(paths, (".tar",))

    @ray_tpu_torch.remote
    def load(path: str) -> Block:
        import tarfile

        samples: Dict[str, Dict[str, Any]] = {}
        order: List[str] = []
        with tarfile.open(path) as tf:
            for member in tf:
                if not member.isfile():
                    continue
                base = os.path.basename(member.name)
                if "." not in base:
                    continue
                key, ext = base.split(".", 1)
                data = tf.extractfile(member).read()
                if key not in samples:
                    samples[key] = {"__key__": key}
                    order.append(key)
                samples[key][ext] = (
                    _decode_wds_member(base, data) if decode else data)
        return [samples[k] for k in order]

    return Datastream([load.remote(p) for p in shards])


def write_webdataset(ds: Datastream, path: str) -> List[str]:
    """Write one .tar shard per block. Arrays go as .npy, str as .txt,
    dict/list as .json, bytes raw."""
    import io
    import json
    import tarfile

    os.makedirs(path, exist_ok=True)

    def encode(value: Any) -> tuple:
        if isinstance(value, np.generic):
            value = value.item()
        if isinstance(value, bytes):
            return "bin", value
        if isinstance(value, str):
            return "txt", value.encode()
        if isinstance(value, np.ndarray):
            buf = io.BytesIO()
            np.save(buf, value)
            return "npy", buf.getvalue()
        return "json", json.dumps(value, default=str).encode()

    def write_block(block: Block, out_path: str) -> None:
        with tarfile.open(out_path, "w") as tf:
            for i, row in enumerate(_block_rows(block)):
                if not isinstance(row, dict):
                    row = {"data": row}
                key = str(row.get("__key__", i))
                for col, value in row.items():
                    if col == "__key__":
                        continue
                    ext, data = encode(value)
                    # the member's LAST extension must be the codec's, or
                    # read_webdataset would decode with the wrong one
                    name = (f"{key}.{col}" if col.endswith(f".{ext}")
                            else f"{key}.{col}.{ext}")
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))

    return ds._write(os.path.join(path, "shard"), "tar", write_block)


def read_mongo(uri: str, database: str, collection: str, *,
               query: Optional[dict] = None,
               parallelism: int = 1) -> Datastream:
    """MongoDB reader (gated: requires pymongo, absent in this image)."""
    try:
        import pymongo  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "read_mongo requires pymongo, which is not installed") from e

    @ray_tpu_torch.remote
    def load(skip: int, limit: int) -> Block:
        import pymongo

        client = pymongo.MongoClient(uri)
        try:
            # sort by _id so skip/limit windows partition deterministically
            # across the parallel shard queries
            cursor = (client[database][collection]
                      .find(query or {}).sort("_id", 1)
                      .skip(skip).limit(limit))
            return _rows_to_block(
                [{k: v for k, v in doc.items() if k != "_id"}
                 for doc in cursor])
        finally:
            client.close()

    import pymongo

    client = pymongo.MongoClient(uri)
    try:
        total = client[database][collection].count_documents(query or {})
    finally:
        client.close()
    per = -(-total // parallelism) if total else 1
    return Datastream([load.remote(i, per)
                       for i in builtins.range(0, max(total, 1), per)])
