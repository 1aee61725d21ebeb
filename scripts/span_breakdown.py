"""One benchmark cell with ``--trace 1``, its traced device time and idle
gaps put down to the program's spans.

    python3 scripts/span_breakdown.py --workload <cell> --seed <n> \\
        --seconds <s> [--out <dir>]

Runs ``benchmark/run.py``'s harness in this process with
``benchmark.trace.reduce`` wrapped: the wrapper returns ``reduce``'s own
summary unchanged and also passes the same events to
``benchmark.spans.attribute``, with the device events' links to their
launching ops read from the profiler's own results
(``benchmark.spans.kineto_links``). After the run it prints one line
``spans {...}`` to standard error (``device_spans``, ``idle_gaps_program``,
the labelled share of ``busy_s``, every label's device seconds and the
program's counters of the traced window) and writes the same JSON to
``<out>/spans_<cell>_<seed>.json`` (default ``benchmark/out/``). The result
line of standard output is the harness's own.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

T_START = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import benchmark.run  # noqa: E402,F401  (the run's cache paths)
from benchmark import harness, spans  # noqa: E402
from benchmark import trace as btrace  # noqa: E402

import torch  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=os.path.join(ROOT, "benchmark", "out"))
    args = ap.parse_args(argv)

    found = {}
    reduce = btrace.reduce
    profilers = []
    events_of = torch.profiler.profile.events

    def events(prof):
        profilers.append(prof)
        return events_of(prof)

    def reduce_and_attribute(events, names):
        summary = reduce(events, names)
        t0 = time.perf_counter()
        try:
            links = spans.kineto_links(profilers[-1]) if profilers else None
            s = spans.attribute(events, names, links)
        except Exception as exc:           # the harness's run goes on
            found["error"] = traceback.format_exc()
            print(f"span_breakdown: attribution failed: {exc!r}",
                  file=sys.stderr, flush=True)
            return summary
        longest = sorted(zip(s.span_gaps, s.gap_ends, s.gap_hosts),
                         key=lambda g: -g[0][1])[:10]
        idle = sorted(s.idle_by_span().items(), key=lambda kv: -kv[1][0])
        found.update(s.breakdown(), busy_s=s.busy_s, labeled_s=s.labeled_s,
                     gap_ends=[[n, sec, end[:100], host[:100]]
                               for (n, sec), end, host in longest],
                     idle_by_span=[[n, sec, k] for n, (sec, k) in idle],
                     labeled_share=s.labeled_s / max(s.busy_s, 1e-12),
                     unlinked_s=s.unlinked_s, window_s=summary.window_s,
                     gaps=len(s.span_gaps),
                     by_span=dict(sorted(s.by_span.items(),
                                         key=lambda kv: -kv[1])),
                     attribute_s=time.perf_counter() - t0)
        return summary

    torch.profiler.profile.events = events
    btrace.reduce = reduce_and_attribute
    rc = harness.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"],
                      T_START)
    try:
        from medmoe_torch.utils import trace as program
        found["counters"] = program.counters()
    except ImportError:
        found["counters"] = None
    found.update(workload=args.workload, seed=args.seed, rc=rc)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"spans_{args.workload}_{args.seed}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(found, f, indent=1)
    print("spans " + json.dumps(found), file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
