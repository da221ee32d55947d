"""Postmortem black box: the flight recorder's crash bundle.

A wedged or dying pipeline's most valuable telemetry is the part that
never reaches an exporter: the last few timeline windows before the
collapse, the trace spans of the batch that hung, the event rings, the
thread stacks. A :class:`BlackBox` is armed per pipeline (env
``PETASTORM_TPU_BLACKBOX=/dir``); on a fatal trigger — ``PipelineHungError``
/ pool abort / worker-crash-budget exhaustion escaping ``Reader.__next__``,
a watchdog abort, an SLO violation or anomaly detection — it writes one
bundle DIRECTORY containing:

* ``manifest.json`` — reason, exception (type/repr/traceback), pid,
  trigger time, file inventory;
* ``snapshot.json`` — the full registry snapshot (trace spans included in
  trace mode; the timeline ring rides ``["timeline"]``);
* ``timeline.json`` — the timeline alone (for ``telemetry timeline``);
* ``stacks.json`` — every live thread's stack at trigger time;
* ``config.json`` — the pipeline's construction summary (kwargs);
* ``reports.json`` — the armed collectors' outputs (quarantine, pruning,
  readahead, autotune, growth, SLO, watchdog, cursor, mesh).

``python -m petastorm_tpu_torch.telemetry postmortem BUNDLE`` renders a human
report with critical-path attribution (docs/observability.md
"Postmortem black box"). Bundles latch per reason and are bounded per
process — a flapping SLO cannot disk-fill a training job.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
import traceback
from typing import Callable, Dict, Optional

from petastorm_tpu_torch.telemetry.timeseries import render_sparkline as _sparkline

logger = logging.getLogger(__name__)

__all__ = ["BLACKBOX_ENV", "BlackBox", "blackbox_dir_from_env",
           "load_bundle", "render_report"]

#: Environment variable: a directory path arms a :class:`BlackBox` on
#: every Reader / MeshDataLoader — fatal triggers write bundles there.
BLACKBOX_ENV = "PETASTORM_TPU_BLACKBOX"

#: Bundle files a renderer may rely on (manifest lists what was written).
_BUNDLE_FILES = ("manifest.json", "snapshot.json", "timeline.json",
                 "stacks.json", "config.json", "reports.json")

#: Per-process bundle cap across all BlackBox instances: a crash loop or
#: flapping detector cannot disk-fill the job.
_MAX_BUNDLES_PER_PROCESS = 8
_process_bundle_count = 0
_process_lock = threading.Lock()


def blackbox_dir_from_env(environ=None) -> Optional[str]:
    value = (environ if environ is not None
             else os.environ).get(BLACKBOX_ENV, "").strip()
    return value or None


def _sanitize(reason: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "-"
                   for c in reason.lower())[:48] or "unknown"


class BlackBox:
    """One pipeline's crash recorder.

    :param directory: bundles land in subdirectories of this path
    :param registry: the pipeline's TelemetryRegistry
    :param label: bundle-name prefix (``reader`` / ``mesh``)
    :param config: JSON-safe construction summary written as
        ``config.json``
    """

    def __init__(self, directory: str, registry, label: str = "pipeline",
                 config: Optional[dict] = None):
        self.directory = directory
        self._registry = registry
        self._label = label
        self._config = dict(config or {})
        self._collectors: Dict[str, Callable[[], object]] = {}
        self._lock = threading.Lock()
        self._written: Dict[str, str] = {}  # reason -> bundle path
        self._seq = 0

    def add_collector(self, name: str, fn: Callable[[], object]) -> None:
        """Register a zero-arg collector whose output joins
        ``reports.json`` under ``name`` (called at trigger time; an
        exception is recorded, never raised)."""
        self._collectors[name] = fn

    def bundles(self) -> Dict[str, str]:
        """``{reason: bundle_path}`` written so far by this instance."""
        with self._lock:
            return dict(self._written)

    def write_bundle(self, reason: str,
                     exc: Optional[BaseException] = None) -> Optional[str]:
        """Write one bundle for ``reason`` (latched: the first trigger per
        reason wins — a sustained incident is one bundle, and later
        triggers return the existing path). Returns the bundle directory,
        or None when the per-process cap is exhausted or the directory is
        unwritable (a dying pipeline must not die harder here)."""
        global _process_bundle_count
        with self._lock:
            existing = self._written.get(reason)
            if existing is not None:
                return existing
            with _process_lock:
                if _process_bundle_count >= _MAX_BUNDLES_PER_PROCESS:
                    return None
                _process_bundle_count += 1
            self._seq += 1
            seq = self._seq
        path = os.path.join(
            self.directory,
            f"{self._label}-{os.getpid()}-{seq:02d}-{_sanitize(reason)}")
        try:
            bundle_path = self._write(path, reason, exc)
        except OSError as e:
            logger.warning("BlackBox could not write bundle %s: %s", path, e)
            return None
        with self._lock:
            self._written[reason] = bundle_path
        logger.error("Postmortem bundle written: %s (reason: %s) — render "
                     "with `python -m petastorm_tpu_torch.telemetry postmortem "
                     "%s`", bundle_path, reason, bundle_path)
        return bundle_path

    def _write(self, path: str, reason: str,
               exc: Optional[BaseException]) -> str:
        from petastorm_tpu_torch.resilience.watchdog import dump_thread_stacks
        os.makedirs(path, exist_ok=True)
        errors: Dict[str, str] = {}

        def _dump(name: str, payload) -> None:
            try:
                with open(os.path.join(path, name), "w") as f:
                    json.dump(payload, f, indent=2, sort_keys=True,
                              default=repr)
            except (OSError, TypeError, ValueError) as e:
                errors[name] = repr(e)

        try:
            snapshot = self._registry.snapshot()
        except Exception as e:  # noqa: BLE001 - a torn registry still gets a manifest
            snapshot = {"error": repr(e)}
        _dump("snapshot.json", snapshot)
        _dump("timeline.json", snapshot.get("timeline") or {})
        try:
            stacks = dump_thread_stacks(max_frames=40)
        except Exception as e:  # noqa: BLE001
            stacks = {"error": repr(e)}
        _dump("stacks.json", stacks)
        _dump("config.json", self._config)
        reports: Dict[str, object] = {}
        for name, fn in sorted(self._collectors.items()):
            try:
                reports[name] = fn()
            except Exception as e:  # noqa: BLE001 - a dead subsystem is itself data
                reports[name] = {"collector_error": repr(e)}
        _dump("reports.json", reports)
        error = None
        if exc is not None:
            error = {"type": type(exc).__name__, "repr": repr(exc),
                     "traceback": "".join(traceback.format_exception(
                         type(exc), exc, exc.__traceback__))}
        manifest = {
            "bundle_version": 1,
            "label": self._label,
            "reason": reason,
            "error": error,
            "pid": os.getpid(),
            # Cold path, operator-facing wall clock: a postmortem's "when"
            # must be a real timestamp, not a perf_counter offset.
            "unix_time_s": time.time(),  # wall-clock-ok
            "files": sorted(set(_BUNDLE_FILES) - set(errors)),
            "write_errors": errors,
        }
        _dump("manifest.json", manifest)
        return path


# --------------------------------------------------------------- rendering
def load_bundle(bundle_dir: str) -> dict:
    """Load a bundle directory into ``{file_stem: payload}`` — raises
    ``OSError``/``ValueError`` when the manifest is missing/corrupt (a
    directory that is not a bundle)."""
    out: dict = {}
    manifest_path = os.path.join(bundle_dir, "manifest.json")
    with open(manifest_path) as f:
        out["manifest"] = json.load(f)
    for name in _BUNDLE_FILES:
        stem = name.rsplit(".", 1)[0]
        if stem in out:
            continue
        try:
            with open(os.path.join(bundle_dir, name)) as f:
                out[stem] = json.load(f)
        except (OSError, ValueError):
            out[stem] = None
    return out


def _critical_path_summary(snapshot: dict) -> list:
    counters = snapshot.get("counters", {}) if snapshot else {}
    wins = {name.rsplit(".", 1)[1]: int(v)
            for name, v in counters.items()
            if name.startswith("trace.critical_path.") and v}
    if not wins:
        return []
    total = sum(wins.values()) or 1
    lines = ["critical path (per delivered batch):"]
    for stage, count in sorted(wins.items(), key=lambda kv: -kv[1]):
        hist = (snapshot.get("histograms", {})
                .get(f"trace.self.{stage}_s") or {})
        p99 = hist.get("p99")
        lines.append(
            f"  {stage:<12} {count:>6} wins ({100 * count // total}%)"
            + (f"  self-time p99 {p99:.6g}s" if p99 else ""))
    dominant = max(wins.items(), key=lambda kv: kv[1])[0]
    lines.append(f"  dominant edge: {dominant}")
    return lines


def _timeline_section(timeline: dict, last: int = 12) -> list:
    windows = (timeline or {}).get("windows", [])
    if not windows:
        return []
    names = set()
    for w in windows:
        names.update(k for k, v in w["series"].items() if v is not None)
    lines = [f"timeline (last {min(last, len(windows))} of {len(windows)} "
             f"windows, {timeline.get('interval_s', '?')}s interval):"]
    for name in sorted(names):
        series = [w["series"].get(name) for w in windows]
        tail = [v for v in series[-last:] if v is not None]
        if not tail:
            continue
        lines.append(f"  {name:<28} {_sparkline(series):<40} "
                     f"last={tail[-1]:.6g}")
    return lines


def render_report(bundle: dict) -> str:
    """Human postmortem from a loaded bundle: what died, the critical-path
    edge, the terminal timeline, anomalies/SLO violations, and where the
    threads were."""
    manifest = bundle.get("manifest", {})
    snapshot = bundle.get("snapshot") or {}
    lines = [
        f"POSTMORTEM: {manifest.get('label', '?')} "
        f"(pid {manifest.get('pid', '?')})",
        f"reason: {manifest.get('reason', '?')}",
    ]
    error = manifest.get("error")
    if error:
        lines.append(f"error: {error.get('type')}: {error.get('repr')}")
        tb = (error.get("traceback") or "").strip()
        if tb:
            lines.append("traceback (most recent call last, tail):")
            lines.extend("  " + ln for ln in tb.splitlines()[-8:])
    lines.append("")
    cp = _critical_path_summary(snapshot)
    if cp:
        lines.extend(cp)
        lines.append("")
    tl = _timeline_section(bundle.get("timeline")
                           or snapshot.get("timeline") or {})
    if tl:
        lines.extend(tl)
        lines.append("")
    events = snapshot.get("events") or {}
    interesting = {k: v for k, v in events.items()
                   if k.startswith(("anomaly.", "slo.", "resilience.",
                                    "mesh.", "discovery."))}
    if interesting:
        lines.append("events (newest last):")
        for name, ring in sorted(interesting.items()):
            for entry in ring[-3:]:
                payload = json.dumps(entry.get("payload", {}),
                                     sort_keys=True, default=str)
                if len(payload) > 140:
                    payload = payload[:137] + "..."
                lines.append(f"  {name} #{entry.get('seq', '?')}: {payload}")
        lines.append("")
    reports = bundle.get("reports") or {}
    explain = reports.get("explain") or snapshot.get("explain")
    if isinstance(explain, dict) and explain.get("operators"):
        # One-line operator-graph provenance: which operator was the
        # measured bottleneck when the pipeline died (full graph via
        # `telemetry explain` over the bundle's snapshot.json).
        bn = (explain.get("profile") or {}).get("bottleneck") or {}
        ops = ">".join(op["op_id"] for op in explain["operators"]
                       if op.get("kind") != "sidecar")
        lines.append(
            f"explain: v{explain.get('version', '?')} {ops}"
            + (f"  bottleneck={bn.get('operator')} ({bn.get('source')})"
               if bn.get("operator") else ""))
        lines.append("")
    elif isinstance(explain, dict) and "hosts" in explain:
        # Mesh rollup flavor: per-host graphs live in the bundle; the
        # report carries the fleet bottleneck census.
        census = explain.get("bottlenecks") or {}
        lines.append(
            f"explain: mesh rollup, {len(explain['hosts'] or {})} host "
            f"graph(s)" + ("  bottlenecks: " + ", ".join(
                f"{op} x{n}" for op, n in
                sorted(census.items(), key=lambda kv: -kv[1]))
                if census else ""))
        lines.append("")
    for name in ("watchdog", "slo", "anomaly", "quarantine", "growth",
                 "mesh"):
        rep = reports.get(name)
        if rep:
            text = json.dumps(rep, sort_keys=True, default=str)
            if len(text) > 400:
                text = text[:397] + "..."
            lines.append(f"{name}: {text}")
    stacks = bundle.get("stacks") or {}
    if stacks and "error" not in stacks:
        lines.append("")
        lines.append(f"thread stacks at trigger ({len(stacks)} threads; "
                     f"innermost frame each):")
        for thread, frames in sorted(stacks.items()):
            tail = frames[-1].replace("\n", " ") if frames else "?"
            if len(tail) > 110:
                tail = tail[:107] + "..."
            lines.append(f"  {thread:<34} {tail}")
    return "\n".join(lines)
