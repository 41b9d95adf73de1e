from sntc_tpu_torch.serve.controller import (
    ServeController,
    SloPolicy,
    SloSignal,
)
from sntc_tpu_torch.serve.fuse import compile_pipeline, compile_serving
from sntc_tpu_torch.serve.streaming import (
    ConsoleSink,
    CsvDirSink,
    DirStreamSource,
    FileStreamSource,
    MemorySink,
    MemorySource,
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
    "ConsoleSink",
    "CsvDirSink",
    "DirStreamSource",
    "FileStreamSource",
    "MemorySink",
    "MemorySource",
    "ServeController",
    "SloPolicy",
    "SloSignal",
    "StreamingQuery",
    "bucket_rows_for",
    "compile_pipeline",
    "compile_serving",
]
