"""CICIDS2017 flow schema — column names, label vocabulary, name normalization.

Counterpart of ``sntc_tpu/data/schema.py`` (the port keeps its own copy):
78 numeric flow features + a 15-value label column, feature names as the
CICFlowMeter export writes them (whitespace normalized by the ingest
layer).  The schema contract the JAX package enforces at serve-time
admission is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List

CICIDS2017_FEATURES: List[str] = [
    "Destination Port",
    "Flow Duration",
    "Total Fwd Packets",
    "Total Backward Packets",
    "Total Length of Fwd Packets",
    "Total Length of Bwd Packets",
    "Fwd Packet Length Max",
    "Fwd Packet Length Min",
    "Fwd Packet Length Mean",
    "Fwd Packet Length Std",
    "Bwd Packet Length Max",
    "Bwd Packet Length Min",
    "Bwd Packet Length Mean",
    "Bwd Packet Length Std",
    "Flow Bytes/s",
    "Flow Packets/s",
    "Flow IAT Mean",
    "Flow IAT Std",
    "Flow IAT Max",
    "Flow IAT Min",
    "Fwd IAT Total",
    "Fwd IAT Mean",
    "Fwd IAT Std",
    "Fwd IAT Max",
    "Fwd IAT Min",
    "Bwd IAT Total",
    "Bwd IAT Mean",
    "Bwd IAT Std",
    "Bwd IAT Max",
    "Bwd IAT Min",
    "Fwd PSH Flags",
    "Bwd PSH Flags",
    "Fwd URG Flags",
    "Bwd URG Flags",
    "Fwd Header Length",
    "Bwd Header Length",
    "Fwd Packets/s",
    "Bwd Packets/s",
    "Min Packet Length",
    "Max Packet Length",
    "Packet Length Mean",
    "Packet Length Std",
    "Packet Length Variance",
    "FIN Flag Count",
    "SYN Flag Count",
    "RST Flag Count",
    "PSH Flag Count",
    "ACK Flag Count",
    "URG Flag Count",
    "CWE Flag Count",
    "ECE Flag Count",
    "Down/Up Ratio",
    "Average Packet Size",
    "Avg Fwd Segment Size",
    "Avg Bwd Segment Size",
    "Fwd Header Length.1",
    "Fwd Avg Bytes/Bulk",
    "Fwd Avg Packets/Bulk",
    "Fwd Avg Bulk Rate",
    "Bwd Avg Bytes/Bulk",
    "Bwd Avg Packets/Bulk",
    "Bwd Avg Bulk Rate",
    "Subflow Fwd Packets",
    "Subflow Fwd Bytes",
    "Subflow Bwd Packets",
    "Subflow Bwd Bytes",
    "Init_Win_bytes_forward",
    "Init_Win_bytes_backward",
    "act_data_pkt_fwd",
    "min_seg_size_forward",
    "Active Mean",
    "Active Std",
    "Active Max",
    "Active Min",
    "Idle Mean",
    "Idle Std",
    "Idle Max",
    "Idle Min",
]

NUM_FEATURES = len(CICIDS2017_FEATURES)
assert NUM_FEATURES == 78, NUM_FEATURES

LABEL_COLUMN = "Label"

#: the 15 CICIDS2017 classes: benign + 14 attack types (SURVEY.md §0.1)
CICIDS2017_LABELS: List[str] = [
    "BENIGN",
    "DoS Hulk",
    "PortScan",
    "DDoS",
    "DoS GoldenEye",
    "FTP-Patator",
    "SSH-Patator",
    "DoS slowloris",
    "DoS Slowhttptest",
    "Bot",
    "Web Attack - Brute Force",
    "Web Attack - XSS",
    "Infiltration",
    "Web Attack - Sql Injection",
    "Heartbleed",
]
assert len(CICIDS2017_LABELS) == 15

#: approximate class priors of the real dataset (benign-heavy imbalance);
#: used by the synthetic generator so imbalance behavior is exercised.
CLASS_PRIORS: Dict[str, float] = {
    "BENIGN": 0.803,
    "DoS Hulk": 0.0816,
    "PortScan": 0.0561,
    "DDoS": 0.0452,
    "DoS GoldenEye": 0.00364,
    "FTP-Patator": 0.00280,
    "SSH-Patator": 0.00208,
    "DoS slowloris": 0.00205,
    "DoS Slowhttptest": 0.00194,
    "Bot": 0.000694,
    "Web Attack - Brute Force": 0.000532,
    "Web Attack - XSS": 0.000230,
    "Infiltration": 0.0000127,
    "Web Attack - Sql Injection": 0.0000074,
    "Heartbleed": 0.0000039,
}

#: raw-CSV label spellings seen in the wild (en-dash mojibake etc.) -> canonical
LABEL_ALIASES: Dict[str, str] = {
    "Web Attack \x96 Brute Force": "Web Attack - Brute Force",
    "Web Attack – Brute Force": "Web Attack - Brute Force",
    "Web Attack \x96 XSS": "Web Attack - XSS",
    "Web Attack – XSS": "Web Attack - XSS",
    "Web Attack \x96 Sql Injection": "Web Attack - Sql Injection",
    "Web Attack – Sql Injection": "Web Attack - Sql Injection",
}


def normalize_feature_name(name: str) -> str:
    """Strip the erratic leading/trailing whitespace of raw CICIDS2017 CSVs."""
    return name.strip()


def normalize_label(label: str) -> str:
    label = label.strip()
    return LABEL_ALIASES.get(label, label)
