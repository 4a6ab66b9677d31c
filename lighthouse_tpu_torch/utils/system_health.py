"""Host health observations (reference ``common/system_health``: load,
memory, disk, network counters surfaced on the lighthouse-specific API).
Reads /proc (Linux) with graceful zeros elsewhere — no external deps."""

from __future__ import annotations

import os
import shutil


def observe(datadir: str | None = None) -> dict:
    load1 = load5 = load15 = 0.0
    try:
        load1, load5, load15 = os.getloadavg()
    except OSError:
        pass

    mem_total = mem_free = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    mem_total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    mem_free = int(line.split()[1]) * 1024
    except OSError:
        pass

    disk_total = disk_free = 0
    try:
        usage = shutil.disk_usage(datadir or "/")
        disk_total, disk_free = usage.total, usage.free
    except OSError:
        pass

    uptime = 0.0
    try:
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except OSError:
        pass

    return {
        "sys_loadavg_1": load1,
        "sys_loadavg_5": load5,
        "sys_loadavg_15": load15,
        "sys_ram_total": mem_total,
        "sys_ram_free": mem_free,
        "disk_node_bytes_total": disk_total,
        "disk_node_bytes_free": disk_free,
        "host_uptime_s": uptime,
        "system_cpu_count": os.cpu_count() or 0,
    }
