"""Host parsers for live capture serving: ``ctypes`` bindings over the
C++ sources beside this file.

Counterpart of ``sntc_tpu/native``.  The NetFlow v5 and pcap parsers
build with ``g++`` on first use into ``sntc_tpu_torch/_build/native/``;
the pure-Python parsers take over where no compiler exists, and
``using_native`` / ``using_native_pcap`` say which one runs.  Both
parse on the host: the flow features reach the card as an ordinary
batch.
"""

from sntc_tpu_torch.native.netflow import (
    NF5_FIELD_NAMES,
    NF5_FIELDS,
    make_datagram,
    netflow_to_flow_frame,
    parse_datagram,
    parse_stream,
    scan_stream,
    using_native,
)
from sntc_tpu_torch.native.pcap import (
    PCAP_FIELD_NAMES,
    PCAP_FIELDS,
    make_packet,
    make_pcap,
    packets_to_flow_frame,
    parse_pcap,
    pcap_to_flow_frame,
    scan_truncation,
)
from sntc_tpu_torch.native.pcap import using_native as using_native_pcap

__all__ = [
    "NF5_FIELDS",
    "NF5_FIELD_NAMES",
    "parse_datagram",
    "parse_stream",
    "scan_stream",
    "make_datagram",
    "netflow_to_flow_frame",
    "using_native",
    "PCAP_FIELDS",
    "PCAP_FIELD_NAMES",
    "parse_pcap",
    "scan_truncation",
    "make_pcap",
    "make_packet",
    "packets_to_flow_frame",
    "pcap_to_flow_frame",
    "using_native_pcap",
]
