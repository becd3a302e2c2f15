"""One run of one cell: the daemon started as its configuration states,
set up, measured for a window of back-to-back labeling cycles, stopped,
and its outputs judged against the plain reference.

Set-up is the daemon's cold start up to its first label write that
carries health labels, then a short warm-up of probing cycles; it ends at
the heartbeat that opens the window. The window's cycles are the
heartbeat's touches (``seams.HeartbeatWatch``); ``/metrics`` is scraped
only at its edges. The card's memory is read through NVML, device-wide,
while this process holds no CUDA context; the reference runs after the
daemon has stopped and the readings are taken.

A traffic mix with a ``tenant`` entry first fills the card: the tenant
(``tenant.py``) takes every device's free memory less ``margin_mib``
before the daemon starts. Once the broker worker is up, set-up counts
``busy_cycles`` heartbeats with the card's memory and the label file read
at each, releases the tenant, stamps the release once NVML shows its
memory back, and waits for the first label write that carries health
labels again (``recover_s``). The soak's warm-up and window follow, the
tenant gone."""

import bisect
import glob
import http.client
import json
import os
import select
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

HERE = Path(__file__).resolve().parent
BOOT = HERE / "boot"
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
    # With a tenant: its report, the card once it held its memory, the
    # card at each busy heartbeat (read as each is seen, in order), those
    # heartbeats, the label file at each, the busy phase's edge scrapes,
    # the release's stamp and the recovery.
    tenant: Optional[dict] = None
    used_tenant: Optional[List[int]] = None
    busy_used: List[List[int]] = field(default_factory=list)
    busy_stamps: List[float] = field(default_factory=list)
    busy_labels: List[Dict[str, str]] = field(default_factory=list)
    busy_scrapes: List[Dict[str, float]] = field(default_factory=list)
    release_t: Optional[float] = None
    recover_s: Optional[float] = None

    @property
    def cycles(self) -> int:
        return max(0, len(self.stamps) - 1)

    def delta(self, key: str) -> float:
        return self.scrape_end.get(key, 0.0) - self.scrape_start.get(key, 0.0)

    def delta_mean(self, family: str, labels: str = "") -> Optional[float]:
        """A histogram's mean over the window's edges, or None."""
        return _mean(self.scrape_start, self.scrape_end, family, labels)

    def busy_mean(self, family: str, labels: str = "") -> Optional[float]:
        """A histogram's mean over the busy phase's edges, or None."""
        if len(self.busy_scrapes) != 2:
            return None
        return _mean(*self.busy_scrapes, family, labels)

    def peaks(self) -> Optional[dict]:
        return work.PEAKS.get(self.device_kind)


def _mean(start: dict, end: dict, family: str, labels: str) -> Optional[float]:
    def delta(key):
        return end.get(key, 0.0) - start.get(key, 0.0)

    count = delta(f"{family}_count{labels}")
    return delta(f"{family}_sum{labels}") / count if count > 0 else None


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


# How long the tenant may take to report what it holds and to give it back.
TENANT_TIMEOUT_S = 120.0


def tenant_command(margin_mib: int) -> List[str]:
    return [sys.executable, str(HERE / "tenant.py"), "--margin-mib", str(margin_mib)]


def _tenant_line(tenant: subprocess.Popen) -> dict:
    """The tenant's next line of JSON, or RunError."""
    ready, _, _ = select.select([tenant.stdout], [], [], TENANT_TIMEOUT_S)
    line = tenant.stdout.readline() if ready else ""
    if not line.startswith("{"):
        raise RunError(f"the tenant gave no report (exit {tenant.poll()}): {line!r}")
    return json.loads(line)


def start_tenant(root: Path, spec: dict):
    """The tenant in a session of its own, with none of the run's
    environment for the daemon and no start-up hook; once it holds the
    memory, its process and its report."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(SCRUB_PREFIXES) and k != "PYTHONPATH"}
    tenant = subprocess.Popen(tenant_command(spec["margin_mib"]), cwd=str(root), env=env,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                              start_new_session=True)
    try:
        report = _tenant_line(tenant)
        if report["forbidden_modules"]:
            raise RunError(f"the tenant held {report['forbidden_modules']}")
    except BaseException:
        _stop(tenant)
        raise
    return tenant, report


def release_tenant(tenant: subprocess.Popen, memory: _Memory, held: int) -> float:
    """Tell the tenant to free its ``held`` bytes; the stamp once NVML
    shows the card's use down by more than half of them (on the CPU, once
    the tenant says it has freed them)."""
    before = memory.read()
    tenant.stdin.write("release\n")
    tenant.stdin.flush()
    if before is None:
        _tenant_line(tenant)
        return time.monotonic()
    deadline = time.monotonic() + TENANT_TIMEOUT_S
    while True:
        used = memory.read()
        now = time.monotonic()
        if sum(used) <= sum(before) - held // 2:
            return now
        if now > deadline:
            raise RunError(f"NVML did not show the tenant's memory back in {TENANT_TIMEOUT_S} s")
        time.sleep(0.0005)


def _wait_ready(proc: subprocess.Popen, output: str, mix: dict, memory: _Memory,
                deadline: float, log_path: str) -> None:
    """Until the daemon's first label write that carries health labels."""
    ready = mix["ready_label"] + "="
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
                return
        except OSError:
            pass
        time.sleep(0.02)


def _busy_phase(run: Run, proc: subprocess.Popen, tenant: subprocess.Popen, port: int,
                watch: seams.HeartbeatWatch, labels: seams.LabelWatch, output: str,
                mix: dict, memory: _Memory, deadline: float, log_path: str) -> None:
    """From the daemon's start on a card the tenant fills, through the
    tenant's release, to the first label write with health labels."""
    def alive(phase):
        if proc.poll() is not None:
            raise RunError(f"daemon exited {proc.returncode} {phase}:\n{_log_tail(log_path)}")
        if time.monotonic() > deadline:
            raise RunError(f"set-up ran out of its {mix['setup_timeout_s']} s {phase}:\n"
                           f"{_log_tail(log_path)}")

    while True:
        alive("before its broker worker was up")
        memory.read()
        try:
            scraped = seams.scrape(port, timeout=2.0)
        except (OSError, http.client.HTTPException):
            scraped = {}
        if scraped.get("tfd_broker_up") == 1.0:
            break
        time.sleep(0.05)
    # The first cycle with the worker up also waits for its pre-warm's
    # attempt: its labels are read, but the busy phase's edges (its first
    # scrape and heartbeat) come after it.
    first = seen = edge = watch.count()
    next_sample = 0.0
    while seen < first + 1 + mix["tenant"]["busy_cycles"]:
        alive("in the busy phase")
        now = time.monotonic()
        if now >= next_sample:
            memory.read()
            next_sample = now + 0.25
        count = watch.count()
        if count == seen:
            time.sleep(0.001)
            continue
        seen = count
        used = memory.read()
        if used is not None:
            run.busy_used.append(used)
        try:
            run.busy_labels.append(ref_labels.parse(Path(output).read_text()))
        except OSError:
            run.busy_labels.append({})
        if not run.busy_scrapes:
            run.busy_scrapes = [seams.scrape(port)]
            edge = seen
    run.busy_scrapes.append(seams.scrape(port))
    run.busy_stamps = watch.stamps()[edge - 1:seen]
    run.release_t = release_tenant(tenant, memory, sum(run.tenant["held_bytes"]))
    try:
        ok = labels.first_carrying_after(run.release_t, mix["recover_timeout_s"])
    except TimeoutError:
        raise RunError(f"no {mix['ready_label']!r} label within {mix['recover_timeout_s']} s "
                       f"of the tenant's release:\n{_log_tail(log_path)}") from None
    run.recover_s = ok - run.release_t
    if tenant.wait(TENANT_TIMEOUT_S) != 0:
        raise RunError(f"the tenant exited {tenant.returncode}")


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
    proc = tenant = labels = None
    try:
        run.used_base = memory.read()
        if "tenant" in mix:
            tenant, run.tenant = start_tenant(root, mix["tenant"])
            run.used_tenant = memory.read()
            labels = seams.LabelWatch(str(Path(output).parent), Path(output).name,
                                      mix["ready_label"])
        with open(log_path, "wb") as log:
            t0 = time.monotonic()
            proc = subprocess.Popen(
                list(config["command"]) + list(mix["args"]), cwd=str(root), env=env,
                stdin=subprocess.DEVNULL, stdout=log, stderr=log, start_new_session=True,
            )
        deadline = t0 + mix["setup_timeout_s"]
        if tenant is None:
            _wait_ready(proc, output, mix, memory, deadline, log_path)
        else:
            _busy_phase(run, proc, tenant, port, watch, labels, output, mix, memory, deadline,
                        log_path)
            # Its reads of the label file stop here, before the warm-up.
            labels.close()
            labels = None
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
        try:
            if proc is not None:
                try:
                    _stop(proc)
                finally:
                    sys.stderr.write(_log_tail(log_path, 2000) + "\n")
        finally:
            if tenant is not None:
                _stop(tenant)
                tenant.stdin.close()
                tenant.stdout.close()
            if labels is not None:
                labels.close()
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
    if run.tenant is not None:
        # While the tenant holds the card: no verdict at any busy heartbeat,
        # and the host's facts at the busy phase's end.
        checks["busy_health_labels"] = (
            sum(len(ref_labels.verdicts(labels)) for labels in run.busy_labels)
            if run.busy_labels else None)
        if want_labels is not None:
            checks["busy_label_mismatches"] = (
                len(ref_labels.fact_mismatches(run.busy_labels[-1], want_labels))
                if run.busy_labels else None)
    return {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}


def correct(checks: Dict[str, dict]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
