"""Where the smoke's time goes: ``chip_smoke.py`` under a sampler of
every thread's ``chip_smoke.py`` frames.

Run the smoke (its own arguments after ``--``) and keep the samples::

    python3 scripts/smoke_sampler.py run --out samples.json [-- --phases 16]

A thread reads every other thread's stack each ``--interval`` seconds
and counts the chain of ``chip_smoke.py`` functions it finds there; a
thread waiting on a child process counts where it waits.  The script
exits with the smoke's code.  Then print each function's inclusive
seconds, nested under its callers::

    python3 scripts/smoke_sampler.py report samples.json [--min-s 1.0]
        [--under serve_forms,data_plane]

Seconds are samples times the interval: a share of the wall-clock, not
a device time.
"""

import argparse
import collections
import json
import os
import runpy
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def run(out: str, interval: float, smoke_args: list) -> int:
    counts: collections.Counter = collections.Counter()
    stop = threading.Event()

    def sample():
        me = threading.get_ident()
        while not stop.is_set():
            for tid, frame in sys._current_frames().items():
                path = []
                while frame is not None and tid != me:
                    if frame.f_code.co_filename == SMOKE:
                        path.append(frame.f_code.co_name)
                    frame = frame.f_back
                if path:
                    counts[" < ".join(path)] += 1
            time.sleep(interval)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    sys.argv = [SMOKE, *smoke_args]
    sys.path[0] = REPO
    rc = 0
    try:
        runpy.run_path(SMOKE, run_name="__main__")
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    finally:
        stop.set()
        sampler.join()
        with open(out, "w") as f:
            json.dump({"interval_s": interval,
                       "counts": counts.most_common()}, f)
    return rc


def report(path: str, min_s: float, under: list) -> None:
    d = json.load(open(path))
    inclusive: collections.Counter = collections.Counter()
    for chain, n in d["counts"]:
        frames = chain.split(" < ")[::-1]  # outermost first
        seen = set()
        for i in range(1, len(frames) + 1):
            key = tuple(frames[:i])
            if key not in seen:  # a recursive chain counts once
                seen.add(key)
                inclusive[key] += n
    for key in sorted(inclusive):
        s = inclusive[key] * d["interval_s"]
        if s >= min_s and (not under or any(u in key for u in under)):
            print(f"{s:8.1f}  {'  ' * (len(key) - 1)}{key[-1]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="run the smoke under the sampler")
    r.add_argument("--out", required=True)
    r.add_argument("--interval", type=float, default=0.2)
    r.add_argument("smoke_args", nargs=argparse.REMAINDER)
    p = sub.add_parser("report", help="inclusive seconds by call chain")
    p.add_argument("samples")
    p.add_argument("--min-s", type=float, default=1.0)
    p.add_argument("--under", default="",
                   help="only chains through these functions (comma list)")
    args = ap.parse_args()
    if args.cmd == "run":
        rest = args.smoke_args[1:] if args.smoke_args[:1] == ["--"] \
            else args.smoke_args
        return run(args.out, args.interval, rest)
    report(args.samples, args.min_s, [u for u in args.under.split(",") if u])
    return 0


if __name__ == "__main__":
    sys.exit(main())
