from sntc_tpu_torch.data.ingest import clean_flows, load_csv, load_csv_dir
from sntc_tpu_torch.data.schema import (
    ADMISSION_MODES,
    CICIDS2017_CONTRACT,
    CICIDS2017_FEATURES,
    CICIDS2017_LABELS,
    LABEL_COLUMN,
    NUM_FEATURES,
    AdmissionResult,
    ColumnSpec,
    SchemaContract,
    SchemaViolation,
)
from sntc_tpu_torch.data.synth import (
    STREAM_SIZES,
    generate_drift_frames,
    generate_frame,
    write_bench_stream,
    write_drift_stream,
    write_raw_csv,
)

__all__ = [
    "STREAM_SIZES",
    "write_bench_stream",
    "ADMISSION_MODES",
    "AdmissionResult",
    "CICIDS2017_CONTRACT",
    "CICIDS2017_FEATURES",
    "CICIDS2017_LABELS",
    "LABEL_COLUMN",
    "NUM_FEATURES",
    "ColumnSpec",
    "SchemaContract",
    "SchemaViolation",
    "clean_flows",
    "generate_drift_frames",
    "generate_frame",
    "load_csv",
    "load_csv_dir",
    "write_drift_stream",
    "write_raw_csv",
]
