"""Start-up hook of every Python process a benchmark run starts: the
daemon and, through the broker, its worker. ``portbench/run.py`` puts this
directory first on the daemon's ``PYTHONPATH`` and names an output
directory in ``PORTBENCH_OUT``; without it the hook does nothing.

What it does in each process:

- ``boot-<pid>.json`` at start-up: the processes the run started.
- When ``gpu_feature_discovery_tpu_torch.ops.healthcheck`` is imported,
  its ``health_pack`` and ``_measure_node_health_traced`` are wrapped: each
  timed CUDA probe's packed outputs (the burn-in pass's checksum and rms,
  the HBM stream's sum, per device) are taken from the port's own
  readback of the pack (its ``.cpu()``), with the probe's end on the
  monotonic clock; the wrap adds no copy and no wait on the device. The
  port exposes none of these outside its process.
- On a probe over several devices, ``sharded_chip_verdicts``,
  ``ici_allreduce_probe``, ``ici_ring_sweep`` and the ``all_reduce`` and
  ``ring_shift`` they call are wrapped too: the record takes each card's
  reduced healthy count and sweep total from the program's own reads of
  them (their ``.item()``), the timed all-reduce's ``checksum_ok`` and
  the sweep's ``links_ok``. The last timed all-reduce's output buffers
  (which the program keeps) and the last sweep's received ranks are read
  once, at ``trace-stop``, after the window. Over one device nothing of
  this runs.
- A thread waits (inotify, no polling) for the harness's ``trace-start``
  file and then, in a process that holds a CUDA context, starts
  ``torch.profiler`` (CUDA activities); at ``trace-stop`` it stops it and
  writes ``trace-<pid>.json``: the trace reduced to what the metrics read,
  with the segment's ends on the monotonic clock.
- At ``trace-stop``, which the harness touches in every run before it
  stops the daemon, and again at exit (``atexit``, and ``os._exit``,
  through which the broker worker leaves), every process writes
  ``probes-<pid>.json``: the probe records and the forbidden top-level
  modules the process holds. The harness refuses a run in which a
  process that wrote ``boot-<pid>.json`` left no such record.

``PORTBENCH_FAULT`` plants a fault for the benchmark's own tests
(``answer``: each probe's HBM sum altered where it is packed; ``stale``:
each probe after the first returns the previous report unrun;
``collective``: card 0's reduced healthy count read one higher by the
program; ``busy_health``: a probe that could not get device memory reads
as a failed probe, ``is_busy_error`` false for every error; ``busy_keep``:
from the first busy failure on, the process keeps 256 MiB of the device
past ``release_probe_memory``; ``busy_leak``: after every busy failure it
keeps 16 MiB more, as long as the device has room). Benchmark runs never
set it.
"""

import atexit
import ctypes
import importlib.abc
import json
import os
import select
import sys
import threading
import time
import weakref

_OUT = os.environ.get("PORTBENCH_OUT", "")
_FAULT = os.environ.get("PORTBENCH_FAULT", "")
_TARGET = "gpu_feature_discovery_tpu_torch.ops.healthcheck"
FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_feature_discovery_tpu")

_records = []
_records_lock = threading.Lock()
_packs = threading.local()
_flushed = False
# The collectives' last outputs, read once after the window: the timed
# all-reduce's buffers (weak: the program's cache owns them) and the last
# sweep's received ranks.
_kept = {}
_after = None
# What the ``busy_keep`` and ``busy_leak`` faults keep: once, and after
# every busy failure.
_busy_kept = []
BUSY_KEEP_BYTES = {"busy_keep": 256 << 20, "busy_leak": 16 << 20}


def _write_json(name, doc):
    path = os.path.join(_OUT, name)
    with open(path + ".part", "w") as f:
        json.dump(doc, f)
    os.replace(path + ".part", path)


def forbidden_modules():
    """The forbidden top-level module names this process holds, compared
    whole (the port's name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _pack_class():
    import torch

    class Pack(torch.Tensor):
        """A probe's pack on the device, whose readback to the host (the
        port's own ``.cpu()``) is kept for the record as it goes by.
        Every other operation on it is the plain tensor's."""

        __torch_function__ = torch._C._disabled_torch_function_impl

        def cpu(self, *args, **kwargs):
            host = torch.Tensor.cpu(self, *args, **kwargs)
            items = getattr(_packs, "items", None)
            if items is not None:
                items.append(host)
            return host

    return Pack


def _patch(hc):
    orig_pack = hc.health_pack
    orig_traced = hc._measure_node_health_traced
    pack_class = _pack_class()
    last = {}

    def health_pack(checksum, rms, hbm_total):
        packed = orig_pack(checksum, rms, hbm_total)
        if _FAULT == "answer":
            packed = packed + packed.new_tensor([0.0, 0.0, 65536.0])
        return packed.as_subclass(pack_class)

    def measure_traced(devices, *args, **kwargs):
        _packs.collective = None
        if _FAULT == "stale" and "report" in last:
            return last["report"]
        _packs.items = []
        try:
            report = orig_traced(devices, *args, **kwargs)
        finally:
            host, _packs.items = _packs.items, None
        last["report"] = report
        # The host copies, read into numbers only when the record is
        # written, after the window.
        record = {"t": time.monotonic(), "devices": [str(d) for d in devices],
                  "values": host[-len(devices):]}
        if len(devices) > 1:
            record["collective"] = _packs.collective = {}
        with _records_lock:
            _records.append(record)
        return report

    hc.health_pack = health_pack
    hc._measure_node_health_traced = measure_traced
    _patch_collectives(hc)
    _patch_busy(hc)


def _patch_busy(hc):
    """The busy path's faults (the module's docstring)."""
    if _FAULT == "busy_health":
        hc.is_busy_error = lambda exc: False
    elif _FAULT in BUSY_KEEP_BYTES:
        orig_release = hc.release_probe_memory

        def release_probe_memory(error=None):
            orig_release(error)
            if _FAULT == "busy_leak" or not _busy_kept:
                import torch

                try:
                    _busy_kept.append(torch.empty(BUSY_KEEP_BYTES[_FAULT], dtype=torch.uint8,
                                                  device="cuda"))
                except torch.OutOfMemoryError:
                    pass

        hc.release_probe_memory = release_probe_memory


def _read_class():
    import torch

    class Read(torch.Tensor):
        """One card's reduced value, whose read by the program (its
        ``.item()``) is kept for the record as it goes by."""

        __torch_function__ = torch._C._disabled_torch_function_impl

        def item(self):
            value = torch.Tensor.item(self)
            if _FAULT == "collective" and self._key == "counts" and self._card == 0:
                value += 1
            with _records_lock:
                self._reads.append([self._card, value])
            return value

    return Read


# The phase of a multi-device probe -> the key its reduced reads go under.
_READS = {"verdicts": "counts", "sweep": "totals"}


def _patch_collectives(hc):
    """Capture a multi-device probe's collectives into its record's
    ``collective`` entry (see the module's docstring)."""
    orig_all_reduce = hc.all_reduce
    orig_ring_shift = hc.ring_shift
    read_class = _read_class()

    def phased(phase, fn, keep):
        def wrapper(*args, **kwargs):
            coll = getattr(_packs, "collective", None)
            if coll is None:
                return fn(*args, **kwargs)
            _packs.phase = phase
            try:
                result = fn(*args, **kwargs)
            finally:
                _packs.phase = None
            with _records_lock:
                keep(coll, result)
            return result
        return wrapper

    def keep_allreduce(coll, result):
        coll["allreduce"] = {"ok": result["checksum_ok"]}

    def keep_sweep(coll, result):
        coll["sweep"] = {"links_ok": result["links_ok"]}

    def all_reduce(tensors, out=None):
        result = orig_all_reduce(tensors, out=out)
        coll = getattr(_packs, "collective", None)
        phase = getattr(_packs, "phase", None)
        if coll is None or phase is None or len(result) < 2:
            return result
        if phase == "allreduce":
            _kept["allreduce_out"] = [weakref.ref(t) for t in result]
            return result
        key = _READS[phase]
        with _records_lock:
            reads = coll.setdefault(key, [])
        wrapped = []
        for card, t in enumerate(result):
            t = t.as_subclass(read_class)
            t._key, t._card, t._reads = key, card, reads
            wrapped.append(t)
        return wrapped

    def ring_shift(tensors, group):
        received = orig_ring_shift(tensors, group)
        if getattr(_packs, "phase", None) == "sweep" and len(received) > 1:
            _kept["received"] = list(received)
        return received

    hc.all_reduce = all_reduce
    hc.ring_shift = ring_shift
    hc.sharded_chip_verdicts = phased("verdicts", hc.sharded_chip_verdicts, lambda c, r: None)
    hc.ici_allreduce_probe = phased("allreduce", hc.ici_allreduce_probe, keep_allreduce)
    hc.ici_ring_sweep = phased("sweep", hc.ici_ring_sweep, keep_sweep)


def read_after_window():
    """The collectives' last outputs, read once after the window: per card
    the timed all-reduce's output summed in float64, its min and max (None
    where the program has dropped the buffer), and the last sweep's
    received ranks. Empty where no multi-device probe ran."""
    import torch

    out = {}
    refs = _kept.get("allreduce_out")
    if refs:
        out["allreduce"] = []
        for ref in refs:
            t = ref()
            out["allreduce"].append(None if t is None else [
                torch.sum(t, dtype=torch.float64).item(), t.min().item(), t.max().item()])
    if "received" in _kept:
        out["received"] = [int(t.item()) for t in _kept["received"]]
    return out


class _Loader(importlib.abc.Loader):
    def __init__(self, inner):
        self._inner = inner

    def create_module(self, spec):
        return self._inner.create_module(spec)

    def exec_module(self, module):
        self._inner.exec_module(module)
        _patch(module)


class _Finder(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name != _TARGET:
            return None
        for finder in sys.meta_path:
            if finder is self or not hasattr(finder, "find_spec"):
                continue
            spec = finder.find_spec(name, path, target)
            if spec is not None:
                spec.loader = _Loader(spec.loader)
                return spec
        return None


def _cuda_ready():
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


IN_MOVED_TO = 0x80
IN_CREATE = 0x100


def _wait_for(name):
    """Block until ``name`` exists in the output directory, woken by
    inotify rather than by polling."""
    libc = ctypes.CDLL(None, use_errno=True)
    fd = libc.inotify_init1(os.O_CLOEXEC | os.O_NONBLOCK)
    try:
        libc.inotify_add_watch(fd, _OUT.encode(), IN_CREATE | IN_MOVED_TO)
        path = os.path.join(_OUT, name)
        while not os.path.exists(path):
            select.select([fd], [], [])
            try:
                os.read(fd, 4096)
            except BlockingIOError:
                pass
    finally:
        os.close(fd)


def _trace_thread():
    """Profile the device from the harness's ``trace-start`` file to its
    ``trace-stop`` file, in a process that holds a CUDA context by then;
    at ``trace-stop`` write this process's record."""
    _wait_for("trace-start")
    prof = None
    if _cuda_ready():
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        t0 = time.monotonic()
        _write_json(f"tracing-{os.getpid()}.json", {"pid": os.getpid(), "t0": t0})
    _wait_for("trace-stop")
    if prof is not None:
        t1 = time.monotonic()
        prof.stop()
        doc = reduce_events(prof.profiler.kineto_results.events())
        doc.update(pid=os.getpid(), t0=t0, t1=t1, host_window_s=t1 - t0)
    global _after
    if _kept and _cuda_ready():
        try:
            _after = read_after_window()
        except Exception as e:  # a reading that fails is judged as missing
            _after = {"error": repr(e)}
    # The record so far, in case the process is killed before it exits.
    _write_probes()
    if prof is not None:
        _write_json(f"trace-{os.getpid()}.json", doc)


def reduce_events(events):
    """The trace reduced: every device operation as ``(name, device,
    start_ns, dur_ns, correlations)``, and the correlation ids of the
    host's ``cudaGraphLaunch`` calls, into ``summarise``'s summary."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device_ops = []
    graph_launches = set()
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            device_ops.append((name, e.device_index(), e.start_ns(), e.duration_ns(),
                               (e.correlation_id(), e.linked_correlation_id())))
        elif name == "cudaGraphLaunch":
            graph_launches.add(e.correlation_id())
    return summarise(device_ops, graph_launches)


def summarise(device_ops, graph_launches):
    """Per device-op name its seconds and count; per device the union of
    its ops' intervals (busy) and the span from its first op's start to
    its last op's end; the kernels launched by graph replays (matched on
    either correlation id) with the replays' count; the idle gaps between
    consecutive ops of a device, summed by the ops on either side."""
    device_ops.sort(key=lambda op: (op[1], op[2]))
    by_name = {}
    graph = {"replays": 0, "kernels": 0, "seconds": 0.0}
    seen_replays = set()
    gaps = {}
    devices = {}
    for name, device, start, dur, corr in device_ops:
        end = start + dur
        entry = by_name.setdefault(name, [0.0, 0])
        entry[0] += dur / 1e9
        entry[1] += 1
        replay = next((c for c in corr if c in graph_launches), None)
        if replay is not None:
            graph["kernels"] += 1
            graph["seconds"] += dur / 1e9
            seen_replays.add(replay)
        state = devices.get(device)
        if state is None:
            devices[device] = {"busy_ns": 0, "first": start, "last": end,
                               "cur": [start, end], "prev": name}
            continue
        cur = state["cur"]
        if start > cur[1]:
            state["busy_ns"] += cur[1] - cur[0]
            key = f"{state['prev']} -> {name}"
            gaps[key] = gaps.get(key, 0.0) + (start - cur[1]) / 1e9
            state["cur"] = [start, end]
        else:
            cur[1] = max(cur[1], end)
        state["last"] = max(state["last"], end)
        state["prev"] = name
    per_device = {}
    for device, state in devices.items():
        cur = state["cur"]
        per_device[str(device)] = {
            "busy_s": (state["busy_ns"] + cur[1] - cur[0]) / 1e9,
            "span_s": (state["last"] - state["first"]) / 1e9,
        }
    graph["replays"] = len(seen_replays)
    return {
        "ops": by_name,
        "devices": per_device,
        "graph": graph,
        "gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
    }


def _write_probes():
    with _records_lock:
        records = [dict(r, values=[h.reshape(3).tolist() for h in r["values"]])
                   for r in _records]
        # The collectives' entries are still written to by a probe in
        # flight: the dump below reads a copy.
        records = json.loads(json.dumps(records))
    doc = {
        "pid": os.getpid(),
        "records": records,
        "forbidden_modules": forbidden_modules(),
    }
    if _after is not None:
        doc["after_window"] = _after
    _write_json(f"probes-{os.getpid()}.json", doc)


def flush():
    global _flushed
    if _flushed or not _OUT:
        return
    _flushed = True
    _write_probes()


def _install():
    sys.meta_path.insert(0, _Finder())
    with open(f"/proc/{os.getpid()}/cmdline", "rb") as f:
        cmdline = f.read().decode(errors="replace").split("\0")
    _write_json(f"boot-{os.getpid()}.json", {"pid": os.getpid(), "cmdline": cmdline})
    threading.Thread(target=_trace_thread, name="portbench-trace", daemon=True).start()
    atexit.register(flush)
    real_exit = os._exit

    def _exit(code):
        try:
            flush()
        finally:
            real_exit(code)

    os._exit = _exit


if _OUT:
    _install()
