#!/usr/bin/env python3
"""Compare two runs of ``chip_smoke.py`` made in one call on one card.

    python3 scripts/compare_smoke_runs.py CHANGE.log PARENT.log

Each log is the standard output of one ``chip_smoke.py`` run. The JSON
lines the two runs share (same phase, same position among that phase's
lines) are paired. Every ``JtargetSS`` and ``validation_JtargetSS`` of a
build in a pair must be equal digit for digit: the script prints how many
values it compared, lists the ones that differ, and exits 1 if any does.
The hot step (phases ``hot_step`` and ``entry``) adds f32 weights to its
flux with atomics, in an order that changes from run to run, so its values
are held to 1e-5 relative instead. The ``routes`` phase's lines are paired
like the others; there the device route's values (``JtargetSS_device``: an
f64 flux summed by atomics) are held to 1e-10 relative, the host route's
digit for digit, and the ``*_rel_err`` fields are not values of a build. It
then prints the end-to-end times of both runs side by side (hot-step
milliseconds, build seconds); those move with the host, so they are
printed, not judged.
"""
from __future__ import annotations

import json
import sys

TIMES = ("step_ms", "seconds_cold", "seconds_warm", "seconds")
F32_ATOMIC_PHASES = ("hot_step", "entry")
F64_ATOMIC_KEYS = ("JtargetSS_device",)  # the routes phase's device route


def phase_lines(path):
    """``{(phase, k): line}`` for the k-th JSON line of each phase."""
    out, seen = {}, {}
    with open(path) as fh:
        for raw in fh:
            raw = raw.strip()
            if not raw.startswith('{"phase"'):
                continue
            line = json.loads(raw)
            k = seen.get(line["phase"], 0)
            seen[line["phase"]] = k + 1
            out[(line["phase"], k)] = line
    return out


def flux_values(obj, prefix=""):
    """Every (path, value) under a key that names a JtargetSS."""
    if isinstance(obj, dict):
        for key, val in obj.items():
            if key.endswith("_rel_err"):
                continue
            if "JtargetSS" in key and not isinstance(val, dict):
                vals = val if isinstance(val, list) else [val]
                for i, v in enumerate(vals):
                    yield f"{prefix}{key}[{i}]", v
            else:
                yield from flux_values(val, f"{prefix}{key}.")
    elif isinstance(obj, list):
        for i, val in enumerate(obj):
            yield from flux_values(val, f"{prefix}{i}.")


def main(argv):
    change, parent = (phase_lines(p) for p in argv[1:3])
    shared = [k for k in change if k in parent
              and change[k].get("check") == parent[k].get("check")]
    compared, hot_step, differing = 0, 0, []
    for key in shared:
        a, b = dict(flux_values(change[key])), dict(flux_values(parent[key]))
        for name in a.keys() & b.keys():
            compared += 1
            if key[0] in F32_ATOMIC_PHASES:
                hot_step += 1
                same = abs(a[name] - b[name]) <= 1e-5 * abs(b[name])
            elif name.split(".")[-1].split("[")[0] in F64_ATOMIC_KEYS:
                same = abs(a[name] - b[name]) <= 1e-10 * abs(b[name])
            else:
                same = a[name] == b[name]
            if not same:
                differing.append((key, name, a[name], b[name]))
    for key, name, x, y in differing:
        print(f"DIFFERS {key[0]}#{key[1]} {name}: change {x!r} parent {y!r}")
    print(json.dumps(dict(paired_lines=len(shared), JtargetSS_compared=compared,
                          of_them_hot_step_to_1e_5=hot_step,
                          JtargetSS_differing=len(differing),
                          only_in_change=sorted({k[0] for k in change if k not in parent}),
                          only_in_parent=sorted({k[0] for k in parent if k not in change}))))
    for key in shared:
        a, b = change[key], parent[key]
        times = {t: (a[t], b[t]) for t in TIMES if t in a and t in b}
        if times:
            label = f"{key[0]}#{key[1]}" + (f" {a.get('tier', a.get('config', ''))}".rstrip())
            print(label, " ".join(f"{t}: change {x:.4g} parent {y:.4g}"
                                  for t, (x, y) in times.items()))
    return 1 if differing or not compared else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
