from sntc_tpu_torch.serve.streaming import (
    CsvDirSink,
    FileStreamSource,
    StreamingQuery,
)
from sntc_tpu_torch.serve.transform import (
    VALID_COL,
    BatchPredictor,
    bucket_rows_for,
)

__all__ = [
    "VALID_COL",
    "BatchPredictor",
    "CsvDirSink",
    "FileStreamSource",
    "StreamingQuery",
    "bucket_rows_for",
]
