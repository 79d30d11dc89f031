from ray_tpu_torch.data.datastream import (
    ActorPoolStrategy,
    Datastream,
    Dataset,
    DataIterator,
    GroupedData,
    from_items,
    from_numpy,
    range as range_,
    range_tensor,
    read_binary_files,
    read_csv,
    read_json,
    read_numpy,
    read_parquet,
    read_tfrecords,
    read_text,
    from_pandas,
    from_arrow,
)

from ray_tpu_torch.data.expressions import ColumnPredicate, col

from ray_tpu_torch.data.datasources import (
    read_images,
    read_mongo,
    read_sql,
    read_webdataset,
    write_webdataset,
)

# reference-compatible module-level names
range = range_  # noqa: A001 (shadows builtin deliberately, like ray.data.range)

from ray_tpu_torch.data import preprocessors
