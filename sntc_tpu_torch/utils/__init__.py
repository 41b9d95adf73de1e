from sntc_tpu_torch.utils.logging import MetricsLogger
from sntc_tpu_torch.utils.profiling import (
    TransferLedger,
    active_ledgers,
    ledger_scope,
    transfer_ledger,
)

__all__ = [
    "MetricsLogger",
    "TransferLedger",
    "active_ledgers",
    "ledger_scope",
    "transfer_ledger",
]
