"""Telemetry CLI: inspect a live pipeline's exported snapshots (the JAX
package's ``python -m petastorm_tpu.telemetry``, less ``explain`` and
``quality``; it reads and writes the same files, so either CLI reads the
other's).

A pipeline process started with ``PETASTORM_TPU_TELEMETRY_EXPORT=/tmp/pt.json``
(or one that called ``PeriodicExporter(registry, path).start()``) keeps a
fresh JSON snapshot on disk; this tool renders it:

    python -m petastorm_tpu_torch.telemetry dump /tmp/pt.json
    python -m petastorm_tpu_torch.telemetry dump /tmp/pt.json --format prometheus
    python -m petastorm_tpu_torch.telemetry watch /tmp/pt.json --interval 2
    python -m petastorm_tpu_torch.telemetry top /tmp/pt.json --interval 2
    python -m petastorm_tpu_torch.telemetry timeline /tmp/pt.json --json series.json
    python -m petastorm_tpu_torch.telemetry trace /tmp/pt.json --out trace.json
    python -m petastorm_tpu_torch.telemetry check /tmp/pt.json --slo input_stall_pct<=1 --anomaly
    python -m petastorm_tpu_torch.telemetry postmortem /tmp/blackbox/reader-123-01-pipelinehungerror
    python -m petastorm_tpu_torch.telemetry serve tcp://0.0.0.0:5556 --flush /tmp/fleet.json
    python -m petastorm_tpu_torch.telemetry top --connect tcp://0.0.0.0:5556
    python -m petastorm_tpu_torch.telemetry top /tmp/fleet.json --follow

``dump`` prints one rendering and exits; ``watch`` re-renders every
``--interval`` seconds until interrupted (or ``--count`` iterations, for
scripting) — including the per-name event rings (straggler / host-lost /
reshard / SLO events) and a ``mesh.*`` per-host table when present.
``top`` is the live ops view over a timeline-enabled pipeline
(``PETASTORM_TPU_TIMELINE=1``): per-series sparklines + current rates,
re-rendered in place. ``timeline`` renders/flushes the rolling series of
one or more snapshots (multiple files federate into a fleet view;
``--json`` writes the merged series for bench artifacts). ``trace``
converts one or more trace-mode snapshots (run the pipeline with
``PETASTORM_TPU_TELEMETRY_TRACE=1``) into Chrome-trace JSON for
``ui.perfetto.dev``, with a lineage + critical-path summary on stdout.
``check`` evaluates SLO rules against a snapshot — plus
the anomaly detectors over its timeline with ``--anomaly`` — and exits
non-zero on any violation: the CI/bench gate. ``postmortem`` renders a black-box
bundle directory (docs/observability.md "Postmortem black box").

The telemetry-fabric commands (docs/observability.md "Telemetry
fabric"): ``serve`` binds a :class:`~petastorm_tpu_torch.telemetry.fabric.
TelemetryAggregator` at a ``tcp://`` or ``ipc://`` address — pipelines started with
``telemetry_publish=addr`` / ``PETASTORM_TPU_TELEMETRY_PUBLISH=addr``
stream to it — and keeps a fleet snapshot flushed to ``--flush PATH``,
where every file subcommand (including ``check --anomaly``) consumes it
unmodified. ``top --connect addr`` binds the same aggregator in-process
and renders the live fleet: aggregate + per-member sparklines, member
liveness (silent members flagged), and the per-tenant accounting table;
given a snapshot path too, it degrades to file mode when the address
cannot be bound. ``top``/``watch`` ``--follow`` waits for a missing or
half-written snapshot file instead of exiting.

Exit codes: 1 when a snapshot file/bundle is missing/unreadable (every
subcommand, unless ``--follow``), 2 when ``check`` finds violations or
anomalies, 1 when ``trace`` finds no trace events.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from petastorm_tpu_torch.telemetry.exporters import from_json, to_prometheus_text
from petastorm_tpu_torch.telemetry.timeseries import render_sparkline as _sparkline

_STAGE_ORDER = ("worker.decode_s", "reader.pool_wait_s", "loader.shuffle_s",
                "loader.host_wait_s", "loader.stage_s",
                "loader.delivery_wait_s")


def _load(path: str) -> dict:
    with open(path) as f:
        return from_json(f.read())


def _render_pretty(snap: dict) -> str:
    lines = [f"schema_version: {snap.get('schema_version', '?')}"]
    if snap.get("pipeline_id"):
        # Registry identity: multi-reader processes / federated
        # merges tell snapshots apart by pipeline, not file stem.
        created = snap.get("created_at")
        lines.append(f"pipeline: {snap['pipeline_id']}"
                     + (f" (created_at {created})" if created else ""))
    gauges = snap.get("gauges", {})
    if gauges:
        lines.append("gauges:")
        for name, value in gauges.items():
            lines.append(f"  {name:<32} {'n/a' if value is None else value}")
    counters = snap.get("counters", {})
    if counters:
        lines.append("counters:")
        for name, value in counters.items():
            lines.append(f"  {name:<32} {value}")
    hists = snap.get("histograms", {})
    if hists:
        lines.append("histograms (count / p50 / p95 / p99 / sum):")
        for name, h in hists.items():
            lines.append(
                f"  {name:<32} {h['count']:>8} / {h['p50']:.6g} / "
                f"{h['p95']:.6g} / {h['p99']:.6g} / {h['sum']:.6g}")
    spans = snap.get("spans", {})
    if spans:
        lines.append("spans (count / total_s / max_s):")
        for name, agg in spans.items():
            lines.append(f"  {name:<32} {agg['count']:>8} / "
                         f"{agg['total_s']:.6g} / {agg['max_s']:.6g}")
    stage = _stage_breakdown(snap)
    if stage:
        lines.append("per-stage seconds:")
        for name, total in stage.items():
            lines.append(f"  {name:<32} {total:.6g}")
    mesh = _render_mesh(snap)
    if mesh:
        lines.extend(mesh)
    events = _render_events(snap)
    if events:
        lines.extend(events)
    return "\n".join(lines)


def _render_mesh(snap: dict) -> list:
    """Per-host mesh ingestion table from the ``mesh.*`` metric family:
    ``dump``/``watch`` render it whenever a mesh pipeline wrote the
    snapshot."""
    counters = snap.get("counters", {})
    gauges = snap.get("gauges", {})
    mesh_counters = {k: v for k, v in counters.items()
                     if k.startswith("mesh.")}
    mesh_gauges = {k: v for k, v in gauges.items() if k.startswith("mesh.")}
    if not mesh_counters and not mesh_gauges:
        return []
    lines = ["mesh:"]
    for name in ("mesh.hosts", "mesh.host_skew_s"):
        if name in mesh_gauges:
            lines.append(f"  {name:<32} {mesh_gauges[name]}")
    for name in ("mesh.ingest_wall_s", "mesh.assemble_stall_s",
                 "mesh.assemble_s", "mesh.reshard_events",
                 "mesh.hosts_lost"):
        if name in mesh_counters:
            lines.append(f"  {name:<32} {mesh_counters[name]}")
    hosts = sorted({k.split(".")[1] for k in mesh_counters
                    if k.startswith("mesh.host") and k.count(".") == 2})
    if hosts:
        lines.append("  per-host (rows / rowgroups / input_stall_s):")
        for h in hosts:
            rows = mesh_counters.get(f"mesh.{h}.rows", 0)
            groups = mesh_counters.get(f"mesh.{h}.rowgroups", 0)
            stall = mesh_counters.get(f"mesh.{h}.input_stall_s", 0)
            lines.append(f"    {h:<10} {rows:>10} / {groups:>6} / {stall}")
    return lines


def _render_events(snap: dict) -> list:
    """The bounded per-name event rings: straggler records, host
    losses, reshards, watchdog dumps, SLO violations."""
    events = snap.get("events")
    if not events:
        return []
    lines = ["events (newest last; seq gaps = evicted):"]
    for name, ring in events.items():
        lines.append(f"  {name}:")
        for entry in ring:
            payload = json.dumps(entry.get("payload", {}), sort_keys=True,
                                 default=str)
            if len(payload) > 120:
                payload = payload[:117] + "..."
            lines.append(f"    #{entry.get('seq', '?'):<6} {payload}")
    return lines


def _series_table(series: dict, names=None, width: int = 40) -> list:
    """Sparkline table lines over ``{name: [values...]}``."""
    lines = []
    for name in sorted(series):
        if names and not any(pat in name for pat in names):
            continue
        values = series[name]
        tail = [v for v in values if v is not None]
        if not tail:
            continue
        lines.append(f"  {name:<30} {_sparkline(values, width):<{width}} "
                     f"last={tail[-1]:.6g}  min={min(tail):.6g}  "
                     f"max={max(tail):.6g}")
    return lines


def _timeline_series(snap: dict) -> dict:
    """``{name: [values...]}`` from a snapshot's embedded timeline."""
    tl = snap.get("timeline") or {}
    windows = tl.get("windows", [])
    names = set()
    for w in windows:
        names.update(w.get("series", {}))
    return {name: [w["series"].get(name) for w in windows]
            for name in sorted(names)}


def _render_service_tenants(snap: dict) -> list:
    """Data-service per-tenant lease/throughput table (docs/service.md):
    built from the dispatcher's ``service.tenant.{tenant}.*`` counter
    family plus the accounting ledger's per-tenant row totals. Empty for
    fleets without a dispatcher member."""
    counters = snap.get("counters") or {}
    tenants = {}
    for name, value in counters.items():
        if not name.startswith("service.tenant."):
            continue
        rest = name[len("service.tenant."):]
        tenant, _, suffix = rest.partition(".")
        if not suffix:
            continue
        tenants.setdefault(tenant, {})[suffix] = value
    if not tenants:
        return []
    rows_by_tenant = (snap.get("accounting") or {}).get("tenants") or {}
    lines = ["service tenants (units granted / delivered / rows):"]
    for tenant in sorted(tenants):
        t = tenants[tenant]
        rows = (rows_by_tenant.get(tenant) or {}).get("rows", 0)
        lines.append(
            f"  {tenant:<14} {t.get('units_granted_total', 0):>8.6g} / "
            f"{t.get('units_delivered_total', 0):>8.6g} / "
            f"{rows:>10.6g}")
    return lines


def _render_fleet(snap: dict) -> list:
    """Fabric-aggregator extras (docs/observability.md "Telemetry
    fabric"): member liveness table + per-tenant accounting. Present in
    ``TelemetryAggregator.fleet_snapshot()`` / ``serve --flush`` output;
    empty for single-pipeline snapshots."""
    lines = []
    members = snap.get("fabric_members") or {}
    if members:
        # Service-fleet members publish dotted role names
        # (service.dispatcher, service.server.<id>, service.client.<id>)
        # which both overflow the old 14-char key column and carry a
        # role worth its own column.
        key_w = max(14, max(len(k) for k in members))
        lines.append(f"fabric members ({len(members)}):")
        for key, m in members.items():
            state = ("left" if m.get("left")
                     else "SILENT" if m.get("silent") else "live")
            role = key.split(".", 2)[1] if key.startswith("service.") \
                else "reader"
            off = m.get("clock_offset_s")
            lines.append(
                f"  {key:<{key_w}} {role:<10} {state:<7} "
                f"tenant={m.get('tenant') or '-':<10} "
                f"windows={m.get('windows_received', 0):<6} "
                f"resyncs={m.get('resyncs', 0):<3} "
                f"clock_offset_s="
                f"{'n/a' if off is None else format(off, '.3f')}")
    lines.extend(_render_service_tenants(snap))
    tenants = (snap.get("accounting") or {}).get("tenants") or {}
    if tenants:
        lines.append("per-tenant accounting (rows / bytes_read / "
                     "bytes_decoded / decode_s / fetch_s / cache_hits):")
        for tenant in sorted(tenants):
            t = tenants[tenant]
            lines.append(
                f"  {tenant:<14} {t.get('rows', 0):>10.6g} / "
                f"{t.get('bytes_read', 0):>12.6g} / "
                f"{t.get('bytes_decoded', 0):>12.6g} / "
                f"{t.get('decode_s', 0):>8.6g} / "
                f"{t.get('fetch_s', 0):>8.6g} / "
                f"{t.get('cache_hits', 0):>8.6g}")
    return lines


def _render_top(snap: dict, series_filter=None) -> str:
    """The `top` screen: headline gauges + anomaly/SLO state + series
    sparklines from the embedded timeline ring."""
    lines = []
    gauges = snap.get("gauges", {})
    counters = snap.get("counters", {})
    head = []
    for name, label in (("loader.input_stall_pct", "stall%"),
                        ("ventilator.backlog", "backlog"),
                        ("discovery.ingest_lag_s", "ingest_lag_s"),
                        ("mesh.host_skew_s", "skew_s"),
                        ("quality.max_drift", "max_drift")):
        value = gauges.get(name)
        if value is not None:
            head.append(f"{label}={value:.6g}")
    # Fleet-level pool utilization (the newest timeline window's derived
    # `pool.utilization` value — sum of per-worker busy fractions /
    # worker count): the headline "are my decode workers busy" number.
    for w in reversed((snap.get("timeline") or {}).get("windows", [])):
        util = w.get("series", {}).get("pool.utilization")
        if util is not None:
            head.append(f"pool_util={util:.2f}")
            break
    for name, label in (("reader.rows", "rows"),
                        ("anomaly.detections_total", "anomalies"),
                        ("slo.violations_total", "slo_violations")):
        value = counters.get(name)
        if value:
            head.append(f"{label}={value:.6g}")
    lines.append("petastorm-tpu top — " + ("  ".join(head) or "no data"))
    series = _timeline_series(snap)
    fed = snap.get("fleet_timeline") or {}
    if not series and not fed.get("series"):
        lines.append("(no timeline in snapshot — run the pipeline with "
                     "PETASTORM_TPU_TIMELINE=1)")
        lines.extend(_render_fleet(snap))
        return "\n".join(lines)
    if series:
        tl = snap.get("timeline", {})
        lines.append(f"timeline: {len(tl.get('windows', []))} windows x "
                     f"{tl.get('interval_s', '?')}s")
        lines.extend(_series_table(series, series_filter))
    if fed.get("series"):
        # Aggregator snapshots carry the per-member federated timeline
        # too; default to the fleet-sum + skew rows (--series h0 widens
        # to one member, --series '' to everything).
        lines.append(f"fleet timeline: {fed.get('depth', '?')} windows x "
                     f"{fed.get('interval_s', '?')}s "
                     f"(--series '' for per-member rows)")
        lines.extend(_series_table(fed["series"],
                                   series_filter or ["fleet:", "skew:"]))
    lines.extend(_render_fleet(snap))
    anomalies = {k: v for k, v in (snap.get("events") or {}).items()
                 if k.startswith(("anomaly.", "slo."))}
    for name, ring in sorted(anomalies.items()):
        for entry in ring[-2:]:
            payload = json.dumps(entry.get("payload", {}), sort_keys=True,
                                 default=str)
            if len(payload) > 110:
                payload = payload[:107] + "..."
            lines.append(f"  ! {name}: {payload}")
    return "\n".join(lines)


def _cmd_timeline(args) -> int:
    """Render (and optionally flush) the rolling series of one or more
    snapshots; multiple files federate into one fleet view keyed by each
    file's basename stem."""
    from petastorm_tpu_torch.telemetry.federation import federate_timelines
    import os
    loaded = []
    for path in args.paths:
        try:
            snap = _load(path)
        except (OSError, ValueError) as e:
            print(f"cannot read snapshot {path}: {e}", file=sys.stderr)
            return 1
        loaded.append((os.path.splitext(os.path.basename(path))[0],
                       snap.get("pipeline_id"),
                       snap.get("timeline") or {}))
    # Federation keys: file stems (human-meaningful), disambiguated by
    # the snapshots' own stable pipeline_id when stems collide (two
    # readers exporting the same filename into different directories
    # do not merge into one member).
    stem_counts = {}
    for stem, _pid, _tl in loaded:
        stem_counts[stem] = stem_counts.get(stem, 0) + 1
    members = {}
    for i, (stem, pid, tl) in enumerate(loaded):
        key = stem
        if stem_counts[stem] > 1:
            key = f"{stem}[{pid or i}]"
        if key in members:  # same stem AND same registry exported twice
            key = f"{stem}[{i}]"
        members[key] = tl
    if len(members) == 1:
        tl = next(iter(members.values()))
        windows = tl.get("windows", [])
        if not windows:
            print("no timeline in the snapshot; run the pipeline with "
                  "PETASTORM_TPU_TIMELINE=1", file=sys.stderr)
            return 1
        names = set()
        for w in windows:
            names.update(w.get("series", {}))
        series = {n: [w["series"].get(n) for w in windows]
                  for n in sorted(names)}
        out = {"interval_s": tl.get("interval_s"),
               "windows": len(windows), "series": series}
    else:
        fed = federate_timelines(members, key_label="file")
        series = fed["series"]
        out = fed
    if args.last:
        series = {k: v[-args.last:] for k, v in series.items()}
        out = dict(out, series=series)  # --json gets what the table shows
    print(f"timeline: {out.get('windows', out.get('depth'))} windows, "
          f"{len(series)} series")
    for line in _series_table(series, args.series or None):
        print(line)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    return 0


def _cmd_postmortem(args) -> int:
    from petastorm_tpu_torch.telemetry.postmortem import load_bundle, render_report
    try:
        bundle = load_bundle(args.bundle)
    except (OSError, ValueError) as e:
        print(f"cannot read postmortem bundle {args.bundle}: {e}",
              file=sys.stderr)
        return 1
    print(render_report(bundle))
    return 0


def _stage_breakdown(snap: dict) -> dict:
    """Cumulative seconds per pipeline stage from a snapshot (counters hold
    ``*_s`` totals; histograms contribute their sums)."""
    out = {}
    counters = snap.get("counters", {})
    hists = snap.get("histograms", {})
    for name in _STAGE_ORDER:
        if name in counters:
            out[name] = counters[name]
        elif name in hists:
            out[name] = hists[name].get("sum", 0.0)
    return out


def _render(snap: dict, fmt: str) -> str:
    if fmt == "json":
        return json.dumps(snap, indent=2, sort_keys=True)
    if fmt == "prometheus":
        return to_prometheus_text(snap)
    return _render_pretty(snap)


def _cmd_trace(args) -> int:
    """Merge trace-mode snapshots into one Chrome-trace JSON file."""
    from petastorm_tpu_torch.telemetry.trace import (complete_lineages,
                                               lineage_index,
                                               write_chrome_trace)
    per_file = []
    critical = {}
    for path in args.paths:
        try:
            snap = _load(path)
        except (OSError, ValueError) as e:
            print(f"cannot read snapshot {path}: {e}", file=sys.stderr)
            return 1
        per_file.append(snap.get("trace_events", []))
        for name, value in snap.get("counters", {}).items():
            if name.startswith("trace.critical_path."):
                stage = name.rsplit(".", 1)[1]
                critical[stage] = critical.get(stage, 0) + int(value)
    if len(per_file) > 1:
        # Multi-snapshot merge = one file per host process, and
        # perf_counter is per-machine (boot-relative): without
        # re-anchoring, hosts land hours apart on the merged timeline.
        # Align each file's earliest span to t=0 — host epochs start
        # near-simultaneously, so lanes line up to within real skew while
        # within-file timing is untouched.
        for file_spans in per_file:
            if not file_spans:
                continue
            base = min(sp.get("start_s", 0.0) for sp in file_spans)
            for sp in file_spans:
                sp["start_s"] = sp.get("start_s", 0.0) - base
    spans = [sp for file_spans in per_file for sp in file_spans]
    if not spans:
        print("no trace events in the given snapshot(s); run the pipeline "
              "with PETASTORM_TPU_TELEMETRY_TRACE=1", file=sys.stderr)
        return 1
    lineages = lineage_index(spans)
    complete = complete_lineages(spans)
    write_chrome_trace(args.out, spans, metadata={
        "critical_path": critical,
        "lineages": len(lineages),
        "complete_lineages": len(complete)})
    print(f"wrote {args.out}: {len(spans)} spans, {len(lineages)} "
          f"row-group lineages ({len(complete)} complete), open in "
          f"ui.perfetto.dev")
    if critical:
        total = sum(critical.values()) or 1
        summary = ", ".join(
            f"{stage}={count} ({100 * count // total}%)"
            for stage, count in sorted(critical.items(),
                                       key=lambda kv: -kv[1]) if count)
        print(f"critical path (per delivered batch): {summary}")
    return 0


def _cmd_check(args) -> int:
    """Evaluate SLO rules against a snapshot; exit 2 on any violation.
    Rules that cannot be evaluated (rate rules without ``--prev``, metrics
    absent from the snapshot, dead gauges) are reported as ``skip`` —
    never as a passing ``ok``: a CI gate that silently skips what it
    claims to check is worse than no gate."""
    from petastorm_tpu_torch.telemetry.slo import (default_rules, parse_rules,
                                             rule_value)
    try:
        snap = _load(args.path)
    except (OSError, ValueError) as e:
        print(f"cannot read snapshot {args.path}: {e}", file=sys.stderr)
        return 1
    prev = None
    dt = None
    if args.prev:
        try:
            prev = _load(args.prev)
        except (OSError, ValueError) as e:
            print(f"cannot read snapshot {args.prev}: {e}", file=sys.stderr)
            return 1
        if not args.window_s or args.window_s <= 0:
            print("--prev needs --window-s > 0 (seconds between the two "
                  "snapshots) to evaluate rate rules", file=sys.stderr)
            return 1
        dt = args.window_s
    if args.slo:
        rules = []
        for spec in args.slo:
            rules.extend(parse_rules(spec))
    else:
        # Default set: rate rules join only when a window exists to
        # evaluate them over.
        rules = [r for r in default_rules()
                 if r.kind != "rate" or prev is not None]
    violations = []
    for rule in rules:
        value = rule_value(rule, snap, prev=prev, dt_s=dt)
        if value is None:
            why = ("needs --prev/--window-s" if rule.kind == "rate"
                   and prev is None else "metric absent from snapshot")
            print(f"skip {rule.name}: {rule.metric} not evaluable ({why})")
        elif value > rule.max_value:
            violations.append(rule.name)
            print(f"FAIL {rule.name}: {rule.metric} = {round(value, 6)} "
                  f"(max {rule.max_value})")
        else:
            print(f"ok   {rule.name}: {rule.metric} = {round(value, 6)} "
                  f"<= {rule.max_value}")
    if args.anomaly:
        # Anomaly gate: replay the detectors over the snapshot's timeline
        # ring (docs/observability.md "Anomaly detection"). Honest
        # skip-vs-ok like the rules above: no timeline = skip, loudly.
        from petastorm_tpu_torch.telemetry.anomaly import (default_anomaly_rules,
                                                     detect_over_timeline)
        timeline = snap.get("timeline")
        if not timeline or not timeline.get("windows"):
            print("skip anomaly: no timeline in snapshot (run the pipeline "
                  "with PETASTORM_TPU_TIMELINE=1)")
        else:
            detections = detect_over_timeline(timeline,
                                              default_anomaly_rules())
            live = snap.get("counters", {}).get("anomaly.detections_total",
                                                0)
            if live and not detections:
                # The live monitor fired but the offline replay did not
                # (a window fell off the bounded ring): the gate must not
                # pass what the pipeline itself flagged.
                detections = [{"rule": "live_monitor", "window": None,
                               "detail": f"anomaly.detections_total="
                                         f"{live} in snapshot"}]
            for det in detections:
                violations.append(f"anomaly:{det['rule']}")
                print(f"FAIL anomaly {det['rule']} at window "
                      f"{det['window']}: {det['detail']}")
            if not detections:
                print(f"ok   anomaly: no detections over "
                      f"{len(timeline['windows'])} windows")
    if violations:
        print(f"{len(violations)} SLO/anomaly violation(s)",
              file=sys.stderr)
        return 2
    return 0


def _cmd_serve(args) -> int:
    """Run a fleet telemetry aggregator: bind ``addr``, fold every
    publisher stream, and (with ``--flush``) keep a fleet snapshot on
    disk that the rest of this CLI — including ``check --anomaly`` —
    consumes unmodified (docs/observability.md "Telemetry fabric")."""
    from petastorm_tpu_torch.telemetry import fabric as _fabric
    rules = None
    if args.slo:
        from petastorm_tpu_torch.telemetry.slo import parse_rules
        rules = [r for spec in args.slo for r in parse_rules(spec)]
    try:
        agg = _fabric.TelemetryAggregator(args.addr,
                                          key_label=args.key_label,
                                          interval_s=args.interval,
                                          slo_rules=rules)
    except Exception as e:  # noqa: BLE001 - bad addr / port in use
        print(f"cannot bind aggregator at {args.addr}: {e}",
              file=sys.stderr)
        return 1
    print(f"telemetry aggregator on {args.addr} "
          f"(beat {args.interval}s"
          + (f", flushing {args.flush}" if args.flush else "")
          + ") — ctrl-c to stop", flush=True)
    beats = 0
    last = time.perf_counter()
    try:
        # Driven inline (no agg.start() thread): poll_once drains the
        # socket with a bounded wait and runs due aggregation ticks.
        while True:
            agg.poll_once()
            now = time.perf_counter()
            if now - last >= args.interval:
                last = now
                beats += 1
                if args.flush:
                    agg.flush(args.flush)
                if args.count and beats >= args.count:
                    break
    except KeyboardInterrupt:
        pass
    finally:
        if args.flush:
            try:
                agg.flush(args.flush)
                print(f"wrote {args.flush}", flush=True)
            except OSError as e:
                print(f"cannot flush {args.flush}: {e}", file=sys.stderr)
        agg.stop()
    return 0


def _cmd_top_live(args):
    """``top --connect``: bind an in-process aggregator and render the
    live fleet every ``--interval``. Returns an exit code, or None to
    degrade to file mode (address cannot be bound, snapshot path given)."""
    from petastorm_tpu_torch.telemetry import fabric as _fabric
    degrade = ("degrading to file mode" if args.path
               else "no snapshot path to fall back to")
    try:
        # Aggregation beats at most 1s apart regardless of the render
        # cadence: member-silence detection must not wait a slow
        # --interval.
        agg = _fabric.TelemetryAggregator(
            args.connect, interval_s=min(args.interval, 1.0))
    except Exception as e:  # noqa: BLE001 - bad addr / port in use
        print(f"cannot bind aggregator at {args.connect}: {e}; {degrade}",
              file=sys.stderr)
        return None if args.path else 1
    renders = 0
    try:
        while True:
            deadline = time.perf_counter() + args.interval
            while time.perf_counter() < deadline:
                agg.poll_once(timeout_s=min(0.2, args.interval))
            snap = agg.fleet_snapshot()
            if renders and not args.no_clear:
                print("\x1b[2J\x1b[H", end="")
            print(_render_top(snap, args.series or None))
            renders += 1
            if args.count and renders >= args.count:
                return 0
            if args.no_clear:
                print("---", flush=True)
    except KeyboardInterrupt:
        return 0
    finally:
        agg.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m petastorm_tpu_torch.telemetry",
        description="Dump, watch, trace-export, or SLO-check a pipeline "
                    "telemetry snapshot file.")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in ("dump", "watch"):
        p = sub.add_parser(name)
        p.add_argument("path", help="snapshot file written by "
                                    "PeriodicExporter / "
                                    "PETASTORM_TPU_TELEMETRY_EXPORT")
        p.add_argument("--format", choices=("pretty", "json", "prometheus"),
                       default="pretty")
    watch = sub.choices["watch"]
    watch.add_argument("--interval", type=float, default=2.0)
    watch.add_argument("--count", type=int, default=0,
                       help="stop after N renders (0 = forever)")
    watch.add_argument("--follow", action="store_true",
                       help="wait for a missing/half-written snapshot "
                            "file instead of exiting")

    top_p = sub.add_parser(
        "top", help="live ops view: timeline sparklines + anomaly state")
    top_p.add_argument("path", nargs="?", default=None,
                       help="snapshot file written by a "
                            "PETASTORM_TPU_TIMELINE-enabled "
                            "pipeline's exporter (optional with "
                            "--connect: then it is the fallback)")
    top_p.add_argument("--interval", type=float, default=2.0)
    top_p.add_argument("--count", type=int, default=0,
                       help="stop after N renders (0 = forever)")
    top_p.add_argument("--series", action="append", default=[],
                       help="substring filter on series names (repeatable)")
    top_p.add_argument("--no-clear", action="store_true",
                       help="append renders instead of redrawing in place")
    top_p.add_argument("--connect", default=None, metavar="ADDR",
                       help="bind an in-process telemetry aggregator at "
                            "this tcp:// or ipc:// address and render the live "
                            "fleet (pipelines publish to it via "
                            "telemetry_publish= / "
                            "PETASTORM_TPU_TELEMETRY_PUBLISH)")
    top_p.add_argument("--follow", action="store_true",
                       help="file mode: wait for a missing/half-written "
                            "snapshot file instead of exiting")

    serve_p = sub.add_parser(
        "serve", help="run a fleet telemetry aggregator (binds an "
                      "address publishers connect to)")
    serve_p.add_argument("addr", help="bind address, e.g. "
                                      "tcp://0.0.0.0:5556 or "
                                      "ipc:///tmp/pt-fabric")
    serve_p.add_argument("--interval", type=float, default=1.0,
                         help="aggregation beat: timeline window / "
                              "silence check / flush cadence")
    serve_p.add_argument("--count", type=int, default=0,
                         help="stop after N beats (0 = forever; "
                              "scripting/CI)")
    serve_p.add_argument("--flush", default=None, metavar="PATH",
                         help="write the fleet snapshot here every beat "
                              "and at exit (consumable by every file "
                              "subcommand incl. `check --anomaly`)")
    serve_p.add_argument("--key-label", default="member",
                         help="federation key label in rollup output "
                              "(default: member)")
    serve_p.add_argument("--slo", action="append", default=[],
                         help="SLO rule spec evaluated on the fleet "
                              "registry every beat (repeatable)")

    tl_p = sub.add_parser(
        "timeline", help="render/flush a snapshot's rolling series "
                         "(multiple files federate)")
    tl_p.add_argument("paths", nargs="+",
                      help="snapshot file(s); >1 federates by file stem")
    tl_p.add_argument("--json", default=None,
                      help="write the (merged) series to this JSON path "
                           "(bench artifacts)")
    tl_p.add_argument("--series", action="append", default=[],
                      help="substring filter on series names (repeatable)")
    tl_p.add_argument("--last", type=int, default=0,
                      help="keep only the newest N windows")

    pm_p = sub.add_parser(
        "postmortem", help="render a black-box bundle directory")
    pm_p.add_argument("bundle", help="bundle directory written by the "
                                     "PETASTORM_TPU_BLACKBOX recorder")

    trace_p = sub.add_parser(
        "trace", help="merge trace-mode snapshot(s) into Chrome-trace JSON")
    trace_p.add_argument("paths", nargs="+",
                         help="trace-mode snapshot file(s) (one per host "
                              "process on a real slice)")
    trace_p.add_argument("--out", required=True,
                         help="Chrome-trace JSON output path "
                              "(ui.perfetto.dev)")

    check_p = sub.add_parser(
        "check", help="evaluate SLO rules; exit 2 on violation (CI gate)")
    check_p.add_argument("path")
    check_p.add_argument("--slo", action="append", default=[],
                         help="rule spec, e.g. 'input_stall_pct<=1' or "
                              "'counter:resilience.worker_crashes<=0' "
                              "(repeatable; default: the documented "
                              "default rules minus rate rules)")
    check_p.add_argument("--prev", default=None,
                         help="earlier snapshot enabling rate rules")
    check_p.add_argument("--window-s", type=float, default=None,
                         help="seconds between --prev and the snapshot "
                              "(required with --prev for rate rules)")
    check_p.add_argument("--anomaly", action="store_true",
                         help="also replay the anomaly detectors over the "
                              "snapshot's timeline (exit 2 on detection)")
    args = parser.parse_args(argv)

    if args.cmd == "trace":
        return _cmd_trace(args)
    if args.cmd == "check":
        return _cmd_check(args)
    if args.cmd == "timeline":
        return _cmd_timeline(args)
    if args.cmd == "postmortem":
        return _cmd_postmortem(args)
    if args.cmd == "serve":
        return _cmd_serve(args)
    if args.cmd == "top" and args.connect:
        rc = _cmd_top_live(args)
        if rc is not None:
            return rc
        # Wire unavailable + snapshot path given: degrade to the file
        # loop below.
    if args.cmd == "top" and not args.path:
        print("top needs a snapshot path or --connect ADDR",
              file=sys.stderr)
        return 1

    renders = 0
    while True:
        try:
            snap = _load(args.path)
        except (OSError, ValueError) as e:
            if getattr(args, "follow", False):
                # --follow: the exporter may not have started (or the
                # file is mid-replace); keep waiting instead of exiting.
                print(f"waiting for snapshot {args.path}: {e}",
                      file=sys.stderr)
                time.sleep(args.interval)  # backoff-ok: follow-mode wait for the exporter
                continue
            print(f"cannot read snapshot {args.path}: {e}", file=sys.stderr)
            return 1
        if args.cmd == "top":
            if renders and not args.no_clear:
                print("\x1b[2J\x1b[H", end="")
            print(_render_top(snap, args.series or None))
        else:
            print(_render(snap, args.format))
        renders += 1
        if args.cmd == "dump" or (args.count and renders >= args.count):
            return 0
        if args.cmd != "top" or args.no_clear:
            print("---", flush=True)
        time.sleep(args.interval)  # backoff-ok: watch/top refresh cadence, not a retry


if __name__ == "__main__":
    sys.exit(main())
