"""Synthetic CICIDS2017-shaped traffic.

Counterpart of ``generate_frame``, the raw-CSV writer and the drift
fixture (``generate_drift_frames``, ``write_drift_stream``) of
``sntc_tpu/data/synth.py``, and of bench config 5's file stream
(``write_bench_stream``): 78 nonneg float flow features, 15 labels with
benign-heavy priors, injected ``Infinity``/``NaN`` values in ``Flow
Bytes/s`` / ``Flow Packets/s``, and a per-class lognormal signature over
four salient flow features.  The same seed draws the same frame as the
JAX package's generator (the numpy calls are the same, in the same
order).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.data.schema import (
    CICIDS2017_FEATURES,
    CICIDS2017_LABELS,
    CLASS_PRIORS,
    LABEL_COLUMN,
    NUM_FEATURES,
)


# Salient axes carrying each class's signature — duration / IAT /
# packet-size levels, the columns a real CICIDS2017 attack visibly moves
# (DDoS: short IATs + long flows; PortScan: tiny packets; etc.).  All
# four are continuous, outside the int-floored set, and outside the
# dirty-injection (Inf/NaN) columns.
_CODE_FEATURES = (1, 16, 8, 12)  # Flow Duration, Flow IAT Mean,
#                                  Fwd/Bwd Packet Length Mean
_CODE_DELTA = 2.2  # per-bit log-space offset, ≈2.2σ vs unit noise —
# measured: a depth-10, 20-tree RF reads the code at macro-F1 ≈ 0.8
# (discriminative, neither saturated nor chance); depth 5 cannot exceed
# ~0.35 at ANY separation on 80%-benign 15-class data (greedy gini
# spends its budget on the large classes first), which is why the bench
# config uses depth 10


def _class_means(n_classes: int, rng: np.random.Generator) -> np.ndarray:
    """Per-class mean offsets in log-space.  Benign (class 0) is the
    origin.  Each attack class c carries (a) an AXIS-ALIGNED signature —
    bit b of c displaces code feature b by ±_CODE_DELTA — so a depth-4+
    tree can recover the class by thresholding the four code features
    one at a time (the structure a real RF exploits on flow data), and
    (b) a diffuse displacement along ~12 random other features (the
    part only a dense model like LR/MLP uses fully)."""
    means = np.zeros((n_classes, NUM_FEATURES), dtype=np.float64)
    rest = np.setdiff1d(np.arange(NUM_FEATURES), np.asarray(_CODE_FEATURES))
    for c in range(1, n_classes):
        for b, j in enumerate(_CODE_FEATURES):
            means[c, j] = _CODE_DELTA if (c >> b) & 1 else -_CODE_DELTA
        informative = rng.choice(rest, size=12, replace=False)
        means[c, informative] = rng.normal(0.0, 2.0, size=12)
    return means


def generate_frame(
    n_rows: int,
    seed: int = 0,
    n_classes: int = 15,
    dirty: bool = True,
    class_priors: Optional[List[float]] = None,
    min_class_fraction: float = 0.0005,
) -> Frame:
    """Generate a Frame with the CICIDS2017 schema (78 features + Label).

    ``dirty=True`` injects Inf/NaN into the two rate columns (0.1% of rows)
    like the real data.  ``min_class_fraction`` floors the rarest-class prior
    so small synthetic draws still contain every class (the real tail classes
    are vanishingly rare; tests need all 15 present).
    """
    if not 1 <= n_classes <= 15:
        raise ValueError("n_classes must be in [1, 15]")
    labels_vocab = CICIDS2017_LABELS[:n_classes]
    rng = np.random.default_rng(seed)

    if class_priors is None:
        priors = np.array([CLASS_PRIORS[l] for l in labels_vocab])
        priors = np.maximum(priors, min_class_fraction)
    else:
        priors = np.asarray(class_priors, dtype=np.float64)
    priors = priors / priors.sum()

    y = rng.choice(n_classes, size=n_rows, p=priors)
    means = _class_means(n_classes, np.random.default_rng(seed + 1))

    # lognormal flows: exp(class mean + noise), scaled per feature
    feature_scale = np.random.default_rng(seed + 2).uniform(
        0.5, 4.0, size=NUM_FEATURES
    )
    # pin the code features' scale so the per-bit separation is the
    # designed _CODE_DELTA·σ regardless of the random per-feature draw
    feature_scale[list(_CODE_FEATURES)] = 2.0
    log_x = means[y] + rng.normal(0.0, 1.0, size=(n_rows, NUM_FEATURES))
    x = np.exp(log_x * feature_scale * 0.5).astype(np.float32)

    # integer-ish columns (ports, counts, flags) get floored
    int_like = [0, 2, 3, 43, 44, 45, 46, 47, 48, 49, 50]
    x[:, int_like] = np.floor(x[:, int_like])

    if dirty:
        n_bad = max(1, int(n_rows * 0.001))
        bytes_col = CICIDS2017_FEATURES.index("Flow Bytes/s")
        pkts_col = CICIDS2017_FEATURES.index("Flow Packets/s")
        bad_rows = rng.choice(n_rows, size=n_bad, replace=False)
        half = n_bad // 2
        x[bad_rows[:half], bytes_col] = np.inf
        x[bad_rows[half:], pkts_col] = np.nan

    cols = {
        name: np.ascontiguousarray(x[:, j])
        for j, name in enumerate(CICIDS2017_FEATURES)
    }
    cols[LABEL_COLUMN] = np.array([labels_vocab[c] for c in y], dtype=object)
    return Frame(cols)


def _raw_header(columns: List[str]) -> List[str]:
    """The raw "MachineLearningCVE" header: erratic leading spaces, and
    'Fwd Header Length' written twice (the ingest dedup maps the second
    occurrence back to 'Fwd Header Length.1')."""
    return [(" " + c if i % 2 else c) for i, c in enumerate(
        "Fwd Header Length" if c == "Fwd Header Length.1" else c
        for c in columns)]


def write_raw_csv(frame: Frame, path: str) -> str:
    """One CSV in the raw "MachineLearningCVE" style (:func:`_raw_header`).
    Float columns are written as float64, whose shortest
    decimal form parses back to the exact same value; the file is
    published by rename so a watching source never reads a partial one."""
    names = frame.columns
    arrays = []
    for c in names:
        a = np.asarray(frame[c])
        if a.dtype.kind == "f":
            a = a.astype(np.float64)
        elif a.dtype == object:
            a = a.astype(str)
        arrays.append(pa.array(a))
    table = pa.Table.from_arrays(arrays, names=_raw_header(names))
    tmp = path + ".tmp"
    pacsv.write_csv(table, tmp)
    os.replace(tmp, path)  # storage: unbounded(synthetic dataset output)
    return path


def write_day_csvs(
    out_dir: str,
    n_rows_per_day: int = 1000,
    n_days: int = 8,
    seed: int = 0,
) -> List[str]:
    """Emulate the 8 "MachineLearningCVE" day files as CSVs on disk, with the
    raw files' erratic leading-space column headers, for ingest tests."""
    os.makedirs(out_dir, exist_ok=True)
    return [
        _write_repr_csv(
            generate_frame(n_rows_per_day, seed=seed + day),
            os.path.join(out_dir, f"day{day}.csv"),
        )
        for day in range(n_days)
    ]


def write_capture_stream(
    out_dir: str,
    n_files: int = 6,
    flows_per_file: int = 3,
    packets_per_flow: int = 6,
    seed: int = 0,
    format: str = "pcap",
    file_gap_s: float = 1.0,
    span_files: bool = True,
    defer_fraction: float = 0.0,
    flush: bool = True,
    flush_advance_s: float = 1e6,
    start_ts: float = 1_700_000_000.0,
) -> dict:
    """Synthetic raw-capture micro-batch stream with known ground-truth
    flows — the drift-fixture discipline applied to capture bytes.

    Writes ``n_files`` capture files (``capture_NNNN.pcap`` or
    ``.nf5``) under ``out_dir``; dropped under a ``serve
    --from-capture`` watch directory each file is one engine
    micro-batch.  File ``i`` starts ``flows_per_file`` new
    deterministic bidirectional TCP flows inside its
    ``[start_ts + i*file_gap_s, +file_gap_s)`` time slot; with
    ``span_files`` every odd flow carries half its packets into the
    NEXT file (windows genuinely cross micro-batch boundaries — what
    the kill-mid-window chaos needs).  ``defer_fraction`` additionally
    moves that fraction of each file's packets into the FOLLOWING
    file's byte stream without changing their timestamps — real
    out-of-order arrival whose fate (accepted out-of-order vs dropped
    ``late_record``) the consumer's lateness bound decides.
    ``flush=True`` appends one terminal file holding a single
    far-future sentinel packet (reserved UDP 5-tuple,
    ``flush_advance_s`` past the last real packet) that drives the
    watermark past every real window, so a full replay emits ALL
    ground-truth flows; the sentinel itself stays in state and never
    emits.

    Returns ``{"files", "packets"/"records", "n_flows",
    "flush_file"}`` where ``packets`` (pcap) is the full ground-truth
    packet matrix in timestamp order — feed it to
    ``packets_to_flow_frame`` for the reference feature rows —
    and ``records`` (netflow) is the ground-truth NF5 record matrix.
    """
    from sntc_tpu_torch.native import make_datagram, make_packet, make_pcap

    if format not in ("pcap", "netflow"):
        raise ValueError(
            f"unknown capture format {format!r} (pcap|netflow)"
        )
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    # per-file event schedules: (ts, payload bytes or record tuple)
    schedules: List[list] = [[] for _ in range(n_files + 1)]
    truth_rows: List[tuple] = []
    flow_idx = 0
    for i in range(n_files):
        t0 = start_ts + i * file_gap_s
        for f in range(flows_per_file):
            src = 0x0A000000 + flow_idx
            dst = 0x0A800000 + (flow_idx % 61)
            sport = 1024 + flow_idx % 40000
            dport = 80 + (flow_idx % 5)
            spans = span_files and (flow_idx % 2 == 1) and i + 1 < n_files
            n_pkts = int(packets_per_flow)
            for j in range(n_pkts):
                # second half of a spanning flow lands in the next
                # file's time slot (the window stays OPEN across the
                # micro-batch boundary)
                in_next = spans and j >= n_pkts // 2
                base = t0 + file_gap_s if in_next else t0
                frac = (f * n_pkts + j) / max(
                    flows_per_file * n_pkts * 2, 1
                )
                ts = base + frac * file_gap_s * 0.9
                fwd = j % 2 == 0
                payload = 40 + 20 * (j % 3) + 5 * (flow_idx % 4)
                file_slot = i + 1 if in_next else i
                if format == "pcap":
                    pkt = make_packet(
                        src if fwd else dst, dst if fwd else src,
                        sport if fwd else dport,
                        dport if fwd else sport,
                        proto=6, payload=payload,
                        flags=0x18 if j else 0x02,
                        window=4096 + 64 * (flow_idx % 8),
                    )
                    schedules[file_slot].append((ts, pkt))
                else:
                    first_ms = int((ts - start_ts) * 1000) + 3_600_000
                    rec = (
                        src if fwd else dst, dst if fwd else src,
                        sport if fwd else dport,
                        dport if fwd else sport,
                        6, 0x18 if j else 0x02, 0, 1 + j % 3,
                        (1 + j % 3) * payload, first_ms,
                        first_ms + 40 + 10 * j, 1, 2, 0, 0,
                    )
                    schedules[file_slot].append((ts, rec))
                truth_rows.append(schedules[file_slot][-1])
            flow_idx += 1
    if defer_fraction > 0:
        # move a deterministic sample of each file's events into the
        # NEXT file (arrival later than newer data; timestamps keep
        # their original event time)
        for i in range(n_files - 1):
            evs = schedules[i]
            n_defer = int(len(evs) * defer_fraction)
            if not n_defer:
                continue
            pick = set(
                rng.choice(len(evs), size=n_defer, replace=False)
                .tolist()
            )
            deferred = [e for j, e in enumerate(evs) if j in pick]
            schedules[i] = [
                e for j, e in enumerate(evs) if j not in pick
            ]
            schedules[i + 1].extend(deferred)
    last_ts = max(ts for ts, _ in truth_rows)
    flush_file = None
    if flush:
        ts = last_ts + flush_advance_s
        if format == "pcap":
            sentinel = make_packet(
                0x01010101, 0x02020202, 9, 9, proto=17, payload=8
            )
            schedules[n_files].append((ts, sentinel))
        else:
            first_ms = int((ts - start_ts) * 1000) + 3_600_000
            schedules[n_files].append((ts, (
                0x01010101, 0x02020202, 9, 9, 17, 0, 0, 1, 8,
                first_ms, first_ms, 1, 2, 0, 0,
            )))
    files: List[str] = []
    ext = "pcap" if format == "pcap" else "nf5"
    for i, events in enumerate(schedules):
        if not events:
            continue
        # arrival order inside a file: schedule order (deferred events
        # trail the file's own, preserving the out-of-order shape)
        path = os.path.join(out_dir, f"capture_{i:04d}.{ext}")
        if format == "pcap":
            data = make_pcap([(ts, pkt) for ts, pkt in events])
        else:
            recs = [rec for _ts, rec in events]
            data = b"".join(
                make_datagram(recs[k:k + 30], seq=k)
                for k in range(0, len(recs), 30)
            )
        tmp = path + ".tmp"
        with open(tmp, "wb") as fobj:
            fobj.write(data)
        # atomic: a watching source never sees partials
        os.replace(tmp, path)  # storage: unbounded(synthetic dataset output)
        files.append(path)
        if flush and i == n_files:
            flush_file = path
    out = {
        "files": files,
        "n_flows": flow_idx,
        "flush_file": flush_file,
    }
    truth_rows.sort(key=lambda e: e[0])
    if format == "pcap":
        from sntc_tpu_torch.native import parse_pcap

        # ground truth via the parser itself (exactly the field
        # extraction the consumer sees), in timestamp order
        all_pcap = make_pcap(truth_rows)
        out["packets"] = parse_pcap(all_pcap)
    else:
        # NF5_FIELD_NAMES[:15] order + the derived duration_ms column
        out["records"] = np.asarray(
            [
                list(rec) + [max(rec[10] - rec[9], 0)]
                for _ts, rec in truth_rows
            ],
            np.float64,
        )
    return out


def generate_drift_frames(
    n_batches: int,
    rows_per_batch: int = 512,
    shift_at: Optional[int] = None,
    seed: int = 0,
    n_classes: int = 8,
    shift_seed: int = 101,
    shift_priors: Optional[List[float]] = None,
) -> List[Frame]:
    """A two-day CICIDS-style micro-batch stream with a deterministic
    distribution shift at batch ``shift_at`` (default: halfway), the
    lifecycle's drift fixture, frame for frame the JAX package's.

    Phase A slices one clean day drawn with the benign-heavy priors and
    the ``seed`` concept; phase B slices a second day with
    ``shift_priors`` (default: benign falls to 15 % and the attack mass
    spreads evenly) AND a concept re-drawn from ``shift_seed``, so both
    the prediction mix and the class-conditional structure move.  Each
    phase is one frame sliced into batches, so its concept is fixed
    across them and the detection latency is a constant."""
    if shift_at is None:
        shift_at = n_batches // 2
    if not 0 < shift_at <= n_batches:
        raise ValueError("shift_at must lie in (0, n_batches]")
    if shift_priors is None:
        shift_priors = [0.15] + [0.85 / (n_classes - 1)] * (n_classes - 1)
    pre = generate_frame(shift_at * rows_per_batch, seed=seed,
                         n_classes=n_classes, dirty=False)
    frames = [pre.slice(i * rows_per_batch, (i + 1) * rows_per_batch)
              for i in range(shift_at)]
    n_post = n_batches - shift_at
    if n_post:
        post = generate_frame(n_post * rows_per_batch, seed=shift_seed,
                              n_classes=n_classes, dirty=False,
                              class_priors=shift_priors)
        frames.extend(post.slice(i * rows_per_batch,
                                 (i + 1) * rows_per_batch)
                      for i in range(n_post))
    return frames


def _write_repr_csv(frame: Frame, path: str) -> str:
    """One CSV byte for byte the JAX package's day and drift-fixture
    writers': the raw header, floats as ``repr`` of their float64 value,
    strings bare.  Published by rename, like :func:`write_raw_csv`."""
    header = ",".join(_raw_header(frame.columns))
    cells = []
    for c in frame.columns:
        a = np.asarray(frame[c])
        cells.append([str(v) for v in a] if a.dtype == object
                     else [repr(v) for v in a.astype(np.float64).tolist()])
    lines = [header] + [",".join(row) for row in zip(*cells)]
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)  # storage: unbounded(synthetic dataset output)
    return path


def write_drift_stream(
    out_dir: str,
    n_batches: int,
    rows_per_batch: int = 512,
    shift_at: Optional[int] = None,
    seed: int = 0,
    n_classes: int = 8,
    shift_seed: int = 101,
    shift_priors: Optional[List[float]] = None,
    frames: Optional[List[Frame]] = None,
) -> List[str]:
    """The :func:`generate_drift_frames` fixture as one raw-header CSV a
    micro-batch (``part_NNNN.csv``), byte-identical to the JAX
    package's: under a serve ``--watch`` directory each file is one
    micro-batch.  ``frames`` writes an already generated fixture (the
    generation arguments are ignored then)."""
    os.makedirs(out_dir, exist_ok=True)
    if frames is None:
        frames = generate_drift_frames(
            n_batches, rows_per_batch, shift_at=shift_at, seed=seed,
            n_classes=n_classes, shift_seed=shift_seed,
            shift_priors=shift_priors)
    return [_write_repr_csv(f, os.path.join(out_dir, f"part_{i:04d}.csv"))
            for i, f in enumerate(frames)]


#: the micro-batch row counts of bench config 5's stream, in turn
STREAM_SIZES = (2048, 1024, 512)


def write_bench_stream(in_dir: str, frame: Frame, passes: int = 1,
                       chunk_cycle=None) -> List[int]:
    """Bench config 5's file stream (``_write_bench5_stream`` of the JAX
    package's ``bench.py``), which configs 5 and 6 serve: ``passes``
    passes over ``frame``, one CSV of its 78 feature columns a file
    (``part_NNNNN.csv``), the files' row counts cycling through
    ``chunk_cycle`` (default :data:`STREAM_SIZES`); the last file of a
    pass holds what is left.  Returns the row count of every file."""
    cycle = chunk_cycle or STREAM_SIZES
    os.makedirs(in_dir, exist_ok=True)
    sizes: List[int] = []
    for _pass in range(passes):
        i = 0
        while i < frame.num_rows:
            size = cycle[len(sizes) % len(cycle)]
            chunk = frame.slice(i, min(i + size, frame.num_rows))
            pacsv.write_csv(
                chunk.select(CICIDS2017_FEATURES).to_arrow(),
                os.path.join(in_dir, f"part_{len(sizes):05d}.csv"),
            )
            i += chunk.num_rows
            sizes.append(chunk.num_rows)
    return sizes
