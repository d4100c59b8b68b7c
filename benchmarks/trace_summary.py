"""Reduce a JAX profiler trace of a GPU run to device metrics.

    python benchmarks/trace_summary.py <trace_dir> [--top 15]

<trace_dir> is what ``jax.profiler.start_trace`` wrote (the solver writes
one when PROXSDP_TPU_TRACE_DIR is set; chip_smoke.py keeps the mcp250 one
under its --out directory).  Prints one JSON object:

* ``window_ms``: first device event start to last device event end;
* ``busy_ms`` / ``idle_share``: union of device event intervals, and
  1 - busy / window;
* ``d2h_copies``: device-to-host memcpy events (with a while-loop program,
  the per-trip predicate reads show up here);
* ``top``: device time by kernel name (numeric suffixes folded), with
  share of the summed event time and count.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re


def device_events(trace_dir: str):
    """(start_ns, duration_ns, name) of every event on the first GPU."""
    import jax

    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(sorted(paths)[-1])
    planes = sorted(
        (p for p in data.planes if p.name.startswith("/device:GPU:")),
        key=lambda p: p.name,
    )
    if not planes:
        raise ValueError(f"the trace under {trace_dir} has no GPU plane")
    return [
        (e.start_ns, e.duration_ns, e.name)
        for line in planes[0].lines
        for e in line.events
    ]


def summarize(events, top: int = 15) -> dict:
    """Window, busy time (interval union), idle share, D2H copies, top ops."""
    if not events:
        raise ValueError("no device events")
    events = sorted(events)
    t0 = events[0][0]
    t1 = max(s + d for s, d, _ in events)
    busy = 0
    cur_s, cur_e = events[0][0], events[0][0] + events[0][1]
    for s, d, _ in events[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
    busy += cur_e - cur_s
    agg = collections.defaultdict(lambda: [0, 0])
    for _, d, name in events:
        key = re.sub(r"[._]\d+$", "", name)
        agg[key][0] += d
        agg[key][1] += 1
    total = sum(v[0] for v in agg.values()) or 1
    ranked = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
    window = max(t1 - t0, 1)
    return dict(
        window_ms=window / 1e6,
        busy_ms=busy / 1e6,
        idle_share=1.0 - busy / window,
        events=len(events),
        d2h_copies=sum(1 for _, _, n in events if "MemcpyD2H" in n),
        top=[
            dict(name=k, ms=d / 1e6, share=d / total, count=c)
            for k, (d, c) in ranked
        ],
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    print(json.dumps(summarize(device_events(args.trace_dir), args.top)))


if __name__ == "__main__":
    main()
