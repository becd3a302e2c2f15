"""One run of one cell: the daemon started as its configuration states,
set up, measured for a window of back-to-back labeling cycles, stopped,
and its outputs judged against the plain reference.

Set-up is the daemon's cold start up to its first label write that
carries health labels, then a short warm-up of probing cycles; it ends at
the heartbeat that opens the window. The window's cycles are the
heartbeat's touches (``seams.HeartbeatWatch``); ``/metrics`` is scraped
only at its edges. The card's memory is read through NVML, device-wide,
while this process holds no CUDA context; the reference runs after the
daemon has stopped and the readings are taken."""

import bisect
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import seams
import work
from reference import burnin, collectives, stream
from reference import labels as ref_labels

BOOT = Path(__file__).resolve().parent / "boot"
# Module names, compared whole by their top-level part, that no process of
# a run may hold: the port is measured, never the JAX package beside it.
FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_feature_discovery_tpu")
# Environment the run never passes on: the daemon's own flags come only
# from the configuration and the traffic mix, and the probe's geometry and
# fault sites stay as shipped.
SCRUB_PREFIXES = ("TFD_", "PORTBENCH_")
STOP_TIMEOUT_S = 30.0
TRACE_TIMEOUT_S = 240.0


class RunError(RuntimeError):
    pass


@dataclass
class Run:
    """What one run recorded, for the metric readers and the judge."""

    cell: dict
    config: dict
    device_kind: str = ""
    setup_s: float = 0.0
    stamps: List[float] = field(default_factory=list)  # window start, then each cycle's end
    scrape_start: Dict[str, float] = field(default_factory=dict)
    scrape_end: Dict[str, float] = field(default_factory=dict)
    used_base: Optional[List[int]] = None
    used_end: Optional[List[int]] = None
    memory_peak: Optional[int] = None
    records: List[dict] = field(default_factory=list)  # every probe the run captured
    probes: List[dict] = field(default_factory=list)  # the window's probes
    traces: List[dict] = field(default_factory=list)
    labels: Dict[str, str] = field(default_factory=dict)
    cpu_s: float = 0.0  # the daemon's and its worker's CPU seconds over the window
    apps: str = ""  # nvidia-smi's compute processes at the window's end
    all_stamps: List[float] = field(default_factory=list)  # every heartbeat of the run
    scrape_times: List[float] = field(default_factory=list)  # each edge scrape's request, response
    after: dict = field(default_factory=dict)  # the collectives' last outputs, read after the window

    @property
    def cycles(self) -> int:
        return max(0, len(self.stamps) - 1)

    def delta(self, key: str) -> float:
        return self.scrape_end.get(key, 0.0) - self.scrape_start.get(key, 0.0)

    def delta_mean(self, family: str, labels: str = "") -> Optional[float]:
        """A histogram's mean over the window's edges, or None."""
        count = self.delta(f"{family}_count{labels}")
        return self.delta(f"{family}_sum{labels}") / count if count > 0 else None

    def peaks(self) -> Optional[dict]:
        return work.PEAKS.get(self.device_kind)


def _format(value: str, slots: dict) -> str:
    for key, sub in slots.items():
        value = value.replace("{" + key + "}", sub)
    return value


def daemon_env(config: dict, slots: dict, out_dir: str, trace: bool) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith(SCRUB_PREFIXES)}
    env.update({k: _format(str(v), slots) for k, v in config["env"].items()})
    env["PYTHONPATH"] = os.pathsep.join([str(BOOT), slots["checkout"]])
    env["PORTBENCH_OUT"] = out_dir
    if trace:
        env["PORTBENCH_TRACE"] = "1"
    build = Path(slots["checkout"]) / "build" / "portbench"
    env["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    env["TRITON_CACHE_DIR"] = str(build / "triton")
    env["CUDA_CACHE_PATH"] = str(build / "nv")
    env["PYTHONUNBUFFERED"] = "1"
    return env


def _session_stats(sid: int) -> Dict[int, List[str]]:
    """``/proc/<pid>/stat``'s fields after the command, per process of the
    session ``sid`` (the daemon and every process it started)."""
    stats = {}
    for stat in glob.glob("/proc/[0-9]*/stat"):
        try:
            with open(stat) as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[3]) == sid:
            stats[int(stat.split("/")[2])] = fields
    return stats


def _session_pids(sid: int) -> List[int]:
    return list(_session_stats(sid))


def session_cpu_s(sid: int) -> float:
    """CPU seconds, user and system, of the session's live processes."""
    tick = os.sysconf("SC_CLK_TCK")
    return sum(int(f[11]) + int(f[12]) for f in _session_stats(sid).values()) / tick


def _stop(proc: subprocess.Popen) -> None:
    """SIGTERM to the daemon (it closes its worker), then SIGKILL to
    whatever of its session is left; returns once every one has ended."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGCONT)
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(STOP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            pass
    deadline = time.monotonic() + STOP_TIMEOUT_S
    while True:
        left = [p for p in _session_pids(proc.pid) if p != os.getpid()]
        if proc.poll() is None:
            left.append(proc.pid)
        if not left:
            break
        for pid in left:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        if proc.poll() is None:
            proc.wait(5)
        if time.monotonic() > deadline:
            raise RunError(f"processes {left} outlived the run")
        time.sleep(0.05)


def _wait_files(pattern: str, timeout: float, want: int = 1) -> List[str]:
    deadline = time.monotonic() + timeout
    while True:
        found = glob.glob(pattern)
        if len(found) >= want or time.monotonic() > deadline:
            return found
        time.sleep(0.05)


def _trace_start(out_dir: str, card: bool) -> None:
    """Start the device trace in every process of the run that holds a
    CUDA context (the bootstrap's thread), and on a card wait until one
    has."""
    Path(out_dir, "trace-start").touch()
    if card and not _wait_files(os.path.join(out_dir, "tracing-*.json"), TRACE_TIMEOUT_S):
        raise RunError("no process of the run started a device trace")


def _booted(out_dir: str) -> Dict[int, str]:
    """Every process of the run that loaded the bootstrap: pid -> command."""
    out = {}
    for path in glob.glob(os.path.join(out_dir, "boot-*.json")):
        doc = json.loads(Path(path).read_text())
        out[doc["pid"]] = " ".join(doc["cmdline"]).strip()
    return out


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X")
    except OSError:
        return False


def _wait_records(out_dir: str) -> None:
    """Once ``trace-stop`` is touched, wait until every live process that
    booted has written its record, so that none the stop kills escapes."""
    deadline = time.monotonic() + TRACE_TIMEOUT_S
    while time.monotonic() < deadline:
        missing = [pid for pid in _booted(out_dir) if _alive(pid)
                   and not os.path.exists(os.path.join(out_dir, f"probes-{pid}.json"))]
        if not missing:
            return
        time.sleep(0.05)


def collect_records(out_dir: str) -> List[dict]:
    """Every probe record of the run, once every process has stopped.
    Each process that booted must have left its record, and none may
    hold a forbidden module: a process killed before it wrote one could
    have held anything, so the run has no result."""
    booted = _booted(out_dir)
    records = []
    for pid, command in booted.items():
        if not os.path.exists(os.path.join(out_dir, f"probes-{pid}.json")):
            raise RunError(f"process {pid} ({command}) left no record of its modules")
    for path in glob.glob(os.path.join(out_dir, "probes-*.json")):
        doc = json.loads(Path(path).read_text())
        if doc["forbidden_modules"]:
            raise RunError(f"process {doc['pid']} ({booted.get(doc['pid'], '?')}) held "
                           f"{doc['forbidden_modules']}")
        records += doc["records"]
    return sorted(records, key=lambda r: r["t"])


def collect_after(out_dir: str) -> dict:
    """The collectives' last outputs that the probing process read after
    the window (``after_window`` in its record), or {} where none did."""
    after = {}
    for path in glob.glob(os.path.join(out_dir, "probes-*.json")):
        after.update(json.loads(Path(path).read_text()).get("after_window", {}))
    return after


def smi_apps() -> str:
    """The card's compute processes and their memory, as nvidia-smi lists
    them (a diagnostic beside ``card_mib_held``)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return str(e)


def _log_tail(path: str, n: int = 4000) -> str:
    try:
        return Path(path).read_bytes()[-n:].decode(errors="replace")
    except OSError:
        return ""


class _Memory:
    """NVML's device-wide used bytes, sampled while the run sets up."""

    def __init__(self, enabled: bool):
        self.nvml = None
        self.peak = None
        if enabled:
            from reference.nvml import Nvml

            self.nvml = Nvml().__enter__()

    def read(self) -> Optional[List[int]]:
        if self.nvml is None:
            return None
        used = self.nvml.used_bytes()
        self.peak = max([self.peak or 0] + used)
        return used

    def close(self) -> None:
        if self.nvml is not None:
            self.nvml.__exit__(None, None, None)


def run_cell(root: Path, cell: dict, config: dict, mix: dict, seconds: float,
             trace: bool, device_kind: str) -> Run:
    """One run. With ``device_kind`` "cpu" (the benchmark's own tests) the
    card's memory, its trace and nvidia-smi are not read."""
    card = device_kind != "cpu"
    run = Run(cell=cell, config=config, device_kind=device_kind)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    out_dir = os.path.join(tmp, "out")
    for d in ("out", "heartbeat", "features.d", "state"):
        os.makedirs(os.path.join(tmp, d))
    port = seams.free_port()
    slots = {"tmp": tmp, "port": str(port), "checkout": str(root)}
    env = daemon_env(config, slots, out_dir, trace)
    output = env["TFD_OUTPUT_FILE"]
    heartbeat = Path(env["TFD_HEARTBEAT_FILE"])
    log_path = os.path.join(tmp, "daemon.log")
    memory = _Memory(card)
    watch = seams.HeartbeatWatch(str(heartbeat.parent), heartbeat.name)
    proc = None
    try:
        run.used_base = memory.read()
        with open(log_path, "wb") as log:
            t0 = time.monotonic()
            proc = subprocess.Popen(
                list(config["command"]) + list(mix["args"]), cwd=str(root), env=env,
                stdin=subprocess.DEVNULL, stdout=log, stderr=log, start_new_session=True,
            )
        ready = mix["ready_label"] + "="
        deadline = t0 + mix["setup_timeout_s"]
        next_sample = 0.0
        while True:
            if proc.poll() is not None:
                raise RunError(f"daemon exited {proc.returncode} in set-up:\n{_log_tail(log_path)}")
            now = time.monotonic()
            if now > deadline:
                raise RunError(f"no {ready!r} label within {mix['setup_timeout_s']} s:\n"
                               f"{_log_tail(log_path)}")
            if now >= next_sample:
                memory.read()
                next_sample = now + 0.25
            try:
                if ready in Path(output).read_text():
                    break
            except OSError:
                pass
            time.sleep(0.02)
        warm_from = watch.count()
        while watch.count() < warm_from + mix["warmup_cycles"]:
            if proc.poll() is not None:
                raise RunError(f"daemon exited {proc.returncode} in warm-up:\n{_log_tail(log_path)}")
            time.sleep(0.01)
        memory.read()
        if trace:
            _trace_start(out_dir, card)
        s1 = time.monotonic()
        run.scrape_start = seams.scrape(port)
        run.scrape_times = [s1, time.monotonic()]
        cpu_start = session_cpu_s(proc.pid)
        t_start = watch.next_after(time.monotonic(), 60)
        run.setup_s = t_start - t0
        time.sleep(max(0.0, t_start + seconds - time.monotonic()))
        t_end = watch.next_after(t_start + seconds, 60)
        run.cpu_s = session_cpu_s(proc.pid) - cpu_start
        s2 = time.monotonic()
        run.scrape_end = seams.scrape(port)
        run.scrape_times += [s2, time.monotonic()]
        run.used_end = memory.read()
        if card:
            run.apps = smi_apps()
        run.labels = ref_labels.parse(Path(output).read_text())
        if not trace:
            # The card's time per probe, from a trace of its own after the
            # window, so that the window and the memory reading run untraced.
            _trace_start(out_dir, card)
            if card:
                time.sleep(mix["card_trace_s"])
        tracing = [json.loads(Path(p).read_text())["pid"]
                   for p in glob.glob(os.path.join(out_dir, "tracing-*.json"))]
        if tracing and proc.pid not in tracing:
            # The daemon waits while the probing process reduces its trace,
            # so that no broker request runs out its deadline meanwhile.
            proc.send_signal(signal.SIGSTOP)
        Path(out_dir, "trace-stop").touch()
        _wait_files(os.path.join(out_dir, "trace-*.json"), TRACE_TIMEOUT_S, len(tracing))
        proc.send_signal(signal.SIGCONT)
        _wait_records(out_dir)
        run.memory_peak = memory.peak
        run.all_stamps = watch.stamps()
        run.stamps = [s for s in run.all_stamps if t_start <= s <= t_end]
        _stop(proc)
        proc = None
        run.records = collect_records(out_dir)
        run.probes = [r for r in run.records if t_start < r["t"] <= t_end]
        run.after = collect_after(out_dir)
        run.traces = [json.loads(Path(p).read_text())
                      for p in glob.glob(os.path.join(out_dir, "trace-*.json"))]
        if card and not run.traces:
            raise RunError("no process of the run wrote a device trace")
        return run
    finally:
        if proc is not None:
            try:
                _stop(proc)
            finally:
                sys.stderr.write(_log_tail(log_path, 2000) + "\n")
        watch.close()
        memory.close()
        shutil.rmtree(tmp, ignore_errors=True)


def reference_readings(config: dict, chips: int, device: str) -> dict:
    """The plain reference at the configuration's probe geometry, on each
    device the run used (each draws its inputs from its own generator)."""
    import torch

    probe = config["probe"]
    out = {"stream_sum": stream.buffer_sum(probe["hbm_mib"]), "burnin": []}
    for i in range(chips):
        dev = torch.device(device, i) if device == "cuda" else torch.device("cpu")
        x, ws = burnin.inputs(probe["size"], probe["depth"], dev)
        out["burnin"].append(burnin.run(x, ws))
        del x, ws
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


# How long after a scrape's response a touch made before it may still be
# unread by the heartbeat thread.
STAMP_LAG_S = 0.05


def heartbeat_count_gap(run: Run) -> float:
    """How far the daemon's own count of full cycles between the two edge
    scrapes lies outside what the heartbeats allow. A cycle counts itself
    before it touches the heartbeat, and cycles run one at a time, so at
    a scrape the count lies between the touches stamped before its
    request and one more than those stamped by its response. A gap means
    the heartbeat seam lost or invented cycles."""
    def stamped(t):
        return bisect.bisect_right(run.all_stamps, t)

    s1_req, s1_resp, s2_req, s2_resp = run.scrape_times
    low = stamped(s2_req) - stamped(s1_resp + STAMP_LAG_S) - 1
    high = stamped(s2_resp + STAMP_LAG_S) + 1 - stamped(s1_req)
    full = run.delta('tfd_cycles_total{outcome="full"}')
    return max(0.0, low - full, full - high)


def collective_gap(run: Run) -> Optional[float]:
    """The values a multi-device cell's probes read back from their three
    reductions that disagree with the plain reference, each missing value
    counted as one: per window probe each card's reduced healthy count
    (the verdict pass), the timed all-reduce's own check and the sweep's
    link check, each card's sweep total; and once, after the window, each
    card's last all-reduce output (its sum, min and max) and each card's
    last received rank. None where the window holds no probe."""
    if not run.probes:
        return None
    n = run.cell["chips"]
    want = collectives.expected(n, run.config["probe"]["allreduce_mib"])

    def wrong(reads, key):
        got = {card: value for card, value in reads.get(key, [])}
        return sum(got.get(i) != w for i, w in enumerate(want[key]))

    gap = 0
    for probe in run.probes:
        coll = probe.get("collective", {})
        gap += wrong(coll, "counts") + wrong(coll, "totals")
        gap += coll.get("allreduce", {}).get("ok") is not True
        gap += coll.get("sweep", {}).get("links_ok") is not True
    outputs = run.after.get("allreduce") or []
    for i in range(n):
        reading = outputs[i] if i < len(outputs) else None
        gap += 3 if reading is None else sum(
            got != w for got, w in zip(reading, (want["sum"], want["element"], want["element"])))
    received = run.after.get("received") or []
    gap += sum((received[i] if i < len(received) else None) != w
               for i, w in enumerate(want["received"]))
    return float(gap)


def judge(run: Run, ref: dict, want_labels: Optional[dict]) -> Dict[str, dict]:
    """Each number compared, with its limit (from the configuration's
    ``limits``; the derivation of each is in PERF.md)."""
    limits = run.config["limits"]
    # With no probe in the window there is nothing to compare: None, which
    # never passes.
    checksum_gap = rms_gap = hbm_gap = None if not run.probes else 0.0
    for probe in run.probes:
        for i, (cs, rms, total) in enumerate(probe["values"]):
            g = burnin.gaps(cs, rms, ref["burnin"][i])
            checksum_gap = max(checksum_gap, g["checksum_gap"])
            rms_gap = max(rms_gap, g["rms_gap"])
            hbm_gap = max(hbm_gap, abs(total - ref["stream_sum"]))
    checks = {
        "unprobed_cycles": abs(run.cycles - len(run.probes)),
        "heartbeat_count_gap": heartbeat_count_gap(run),
        "hbm_sum_gap": hbm_gap,
        "checksum_gap": checksum_gap,
        "rms_gap": rms_gap,
    }
    if run.cell["chips"] > 1:
        checks["collective_gap"] = collective_gap(run)
    if want_labels is not None:
        checks["label_mismatches"] = len(ref_labels.mismatches(
            run.labels, want_labels, run.cell["chips"]))
    return {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}


def correct(checks: Dict[str, dict]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
