"""Stateful flow-feature engine: crash-safe keyed session windows from
raw captures to CICIDS2017 feature rows ([B:11]).

Counterpart of ``sntc_tpu/flow``, with the same emissions and the same
snapshot bytes for the same stream.

- :class:`FlowFeatureEngine` — the keyed window operator (watermarks,
  late/out-of-order policy, bounded state, snapshot/restore);
- :class:`PcapFlowMeter` / :class:`NetFlowMeter` — keying + emission
  over the native parsers' record matrices (emission defers to the
  hardened batch meters, so windowed and whole-capture features can
  never drift);
- :class:`FlowCaptureSource` — the ``StreamSource`` adapter opening
  end-to-end raw-capture → features → classify serving
  (``python -m sntc_tpu_torch serve --from-capture pcap ...``);
- :class:`FlowStateStore` — snapshot-at-commit persistence under the
  atomic-publish + sha256 discipline of the storage plane.

Each takes a daemon tenant's ``tenant``: its series and events carry
the label, its fault points (``flow.evict``, ``flow.emit``,
``flow.state_snapshot``) are looked up under ``tenant/<id>/`` first,
and the serve daemon keeps its state under ``tenant/<id>/ckpt/
flow_state``.
"""

from sntc_tpu_torch.flow.engine import (
    FlowFeatureEngine,
    NetFlowMeter,
    PcapFlowMeter,
)
from sntc_tpu_torch.flow.source import FORMATS, FlowCaptureSource
from sntc_tpu_torch.flow.state import (
    FlowStateCorruptError,
    FlowStateError,
    FlowStateStore,
)

__all__ = [
    "FlowFeatureEngine",
    "PcapFlowMeter",
    "NetFlowMeter",
    "FlowCaptureSource",
    "FORMATS",
    "FlowStateStore",
    "FlowStateError",
    "FlowStateCorruptError",
]
