from sntc_tpu_torch.serve.controller import (
    ServeController,
    SloPolicy,
    SloSignal,
)
from sntc_tpu_torch.serve.fuse import compile_pipeline, compile_serving
from sntc_tpu_torch.serve.ingress import (
    CsvSpoolSource,
    IngressSpool,
    NetFlowSpoolSource,
    TcpRowIngress,
    UdpIngressListener,
    build_ingress,
    frame_rows,
    wire_committed_offset,
)
from sntc_tpu_torch.serve.netflow_source import (
    NetFlowDirSource,
    PcapDirSource,
    capture_udp,
)
from sntc_tpu_torch.serve.streaming import (
    ConsoleSink,
    CsvDirSink,
    DirStreamSource,
    FileStreamSource,
    MemorySink,
    MemorySource,
    StreamingQuery,
)
from sntc_tpu_torch.serve.tenancy import (
    ServeDaemon,
    TenantSpec,
    TenantStream,
)
from sntc_tpu_torch.serve.transform import (
    VALID_COL,
    BatchPredictor,
    bucket_rows_for,
)

__all__ = [
    "CsvSpoolSource",
    "IngressSpool",
    "NetFlowDirSource",
    "NetFlowSpoolSource",
    "PcapDirSource",
    "TcpRowIngress",
    "UdpIngressListener",
    "VALID_COL",
    "BatchPredictor",
    "ConsoleSink",
    "CsvDirSink",
    "DirStreamSource",
    "FileStreamSource",
    "MemorySink",
    "MemorySource",
    "ServeController",
    "ServeDaemon",
    "SloPolicy",
    "SloSignal",
    "StreamingQuery",
    "TenantSpec",
    "TenantStream",
    "build_ingress",
    "bucket_rows_for",
    "capture_udp",
    "compile_pipeline",
    "compile_serving",
    "frame_rows",
    "wire_committed_offset",
]
