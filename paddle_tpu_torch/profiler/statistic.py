"""Profiler statistics and report tables.

Port of `paddle_tpu/profiler/statistic.py`: the host span table over
the `RecordEvent` recorder, and the device table, which reads the CUDA
kernel events of a `torch.profiler.profile` (the JAX package reads the
TPU plane of an xplane file). When the profiler read no device kernel
(no card, or a machine whose profiler returns none), the device table
is one line saying so, never an empty table.
"""
from __future__ import annotations

from enum import Enum


class SortedKeys(Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


_SORT_FIELD = {
    SortedKeys.CPUTotal: "total", SortedKeys.GPUTotal: "total",
    SortedKeys.CPUAvg: "avg", SortedKeys.GPUAvg: "avg",
    SortedKeys.CPUMax: "max", SortedKeys.GPUMax: "max",
    SortedKeys.CPUMin: "min", SortedKeys.GPUMin: "min",
}

#: the device table's line when the profiler read no device kernel
NO_DEVICE_KERNELS = ("Device (CUDA) Kernel Summary: no device kernels "
                     "were read")


def _aggregate(events):
    """events: [{name, dur(us), ...}] -> {name: stats dict}."""
    by_name = {}
    for e in events:
        st = by_name.setdefault(e["name"], {
            "calls": 0, "total": 0.0, "max": 0.0, "min": float("inf")})
        d = e["dur"] / 1e3  # us -> ms
        st["calls"] += 1
        st["total"] += d
        st["max"] = max(st["max"], d)
        st["min"] = min(st["min"], d)
    for st in by_name.values():
        st["avg"] = st["total"] / max(st["calls"], 1)
    return by_name


def _table(title, headers, rows, widths):
    sep = "-" * (sum(widths) + len(widths) * 2)
    lines = [sep, title, sep,
             "  ".join(h.ljust(w) if i == 0 else h.rjust(w)
                       for i, (h, w) in enumerate(zip(headers, widths)))]
    for row in rows:
        lines.append("  ".join(
            str(c)[:widths[0]].ljust(widths[0]) if i == 0
            else str(c).rjust(w)
            for i, (c, w) in enumerate(zip(row, widths))))
    lines.append(sep)
    return "\n".join(lines)


def host_statistic_table(events, sorted_by=SortedKeys.CPUTotal,
                         time_unit="ms", top_k=0):
    """The span table over recorded host spans."""
    stats = _aggregate(events)
    field = _SORT_FIELD.get(sorted_by, "total")
    items = sorted(stats.items(), key=lambda kv: -kv[1][field])
    if top_k:
        items = items[:top_k]
    gtotal = sum(st["total"] for _, st in stats.items()) or 1.0
    rows = [(name, st["calls"], f"{st['total']:.3f}",
             f"{st['avg']:.3f}", f"{st['max']:.3f}",
             f"{st['min'] if st['min'] != float('inf') else 0:.3f}",
             f"{100 * st['total'] / gtotal:.2f}%")
            for name, st in items]
    return _table(
        f"Host Event Summary (sorted by {field}, {time_unit})",
        ["Name", "Calls", "Total", "Avg", "Max", "Min", "Ratio"],
        rows, [44, 7, 11, 9, 9, 9, 8])


def device_kernel_times(prof):
    """{kernel name: (total device us, launches)} over the CUDA events
    of a finished `torch.profiler.profile`."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            out[e.key] = (float(e.self_device_time_total), int(e.count))
    return out


def device_statistic_table(prof, top_k=30, n_steps=1):
    """The kernel table of a finished `torch.profiler.profile`, or
    `NO_DEVICE_KERNELS` when it read none."""
    times = device_kernel_times(prof)
    if not times:
        return NO_DEVICE_KERNELS
    total = sum(us for us, _ in times.values()) or 1.0
    rows = [(name, n // n_steps, f"{us / 1e3 / n_steps:.3f}",
             f"{100 * us / total:.2f}%")
            for name, (us, n) in sorted(times.items(),
                                        key=lambda kv: -kv[1][0])[:top_k]]
    return _table(
        f"Device (CUDA) Kernel Summary — {total / 1e3 / n_steps:.3f}"
        f" ms/step over {len(times)} kernels",
        ["Kernel", "Calls", "ms", "Ratio"], rows, [64, 7, 11, 8])


def statistic_report(events, prof=None, sorted_by=SortedKeys.CPUTotal,
                     top_k=30, n_steps=1):
    """The host table, and the device table when `prof` (a finished
    `torch.profiler.profile`) is given."""
    parts = [host_statistic_table(events, sorted_by, top_k=top_k)]
    if prof is not None:
        parts.append(device_statistic_table(prof, top_k=top_k,
                                            n_steps=n_steps))
    return "\n\n".join(parts)
