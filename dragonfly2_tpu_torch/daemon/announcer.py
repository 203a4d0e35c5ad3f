"""The daemon's announcer: the port's copy of
``dragonfly2_tpu/daemon/announcer.py``. It registers this host with the
schedulers, keeps the registration alive and leaves at the daemon's stop.

``host_wire`` is the host's one identity (the AnnounceHost body, and less
its telemetry the host record of every conductor). ``start`` announces
twice: the first answer's ``sched_wall`` echo completes a clock sample
(``t0``/``t1`` around the call on an anchored wall clock, skewed by the
config's ``clock_offset_s``) that the second announce carries, so a fresh
daemon's clock is alignable at once. An answer's ``scorecard`` becomes the
flight recorder's ``scorecard_snapshot``. ``stop`` cancels the periodic
announce and calls ``leave_host``.

Telemetry has the JAX keys (``cpu_percent``, ``mem_percent``,
``disk_free``), read from the standard library where the JAX announcer
reads ``psutil``: ``/proc/stat`` deltas between two announces (0.0 at the
first, as ``psutil.cpu_percent(interval=None)`` gives), ``/proc/meminfo``
and ``os.statvfs("/")``; ``{}`` where they cannot be read.
"""

from __future__ import annotations

import asyncio
import os
import time

from dragonfly2_tpu_torch.pkg import dflog, idgen

log = dflog.get("daemon.announcer")


class _CpuPercent:
    """Busy share of all CPUs since the last call, from ``/proc/stat``:
    busy is the total less idle and iowait, the total less guest time
    (already in user and nice), rounded to 0.1 as psutil rounds it."""

    def __init__(self):
        self._last: tuple[float, float] | None = None

    @staticmethod
    def _times() -> tuple[float, float]:
        with open("/proc/stat") as f:
            fields = [float(v) for v in f.readline().split()[1:]]
        fields += [0.0] * (10 - len(fields))
        total = sum(fields) - fields[8] - fields[9]
        return total, total - fields[3] - fields[4]

    def __call__(self) -> float:
        total, busy = self._times()
        last, self._last = self._last, (total, busy)
        if last is None or total <= last[0]:
            return 0.0
        return round(100.0 * (busy - last[1]) / (total - last[0]), 1)


def _mem_percent() -> float:
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            name, _, rest = line.partition(":")
            info[name] = int(rest.split()[0])
    total = info["MemTotal"]
    return round(100.0 * (total - info["MemAvailable"]) / total, 1)


def _disk_free(path: str = "/") -> int:
    st = os.statvfs(path)
    return st.f_bavail * st.f_frsize


class Announcer:
    def __init__(self, config, scheduler_client, *, peer_port: int,
                 upload_port: int, interval: float = 30.0, recorder=None):
        self.config = config
        self.scheduler_client = scheduler_client
        self.peer_port = peer_port
        self.upload_port = upload_port
        self.interval = interval
        self.host_id = idgen.host_id(config.host.hostname, peer_port)
        self._task: asyncio.Task | None = None
        self._wall0 = time.time() + config.clock_offset_s
        self._pc0 = time.perf_counter()
        self._pending_clock: dict | None = None
        self._cpu = _CpuPercent()
        # The flight recorder this host's scorecard row is kept in.
        self.recorder = recorder

    def _wall_now(self) -> float:
        return self._wall0 + (time.perf_counter() - self._pc0)

    def host_wire(self) -> dict:
        h = self.config.host
        return {
            "id": self.host_id,
            "hostname": h.hostname,
            "ip": h.ip,
            "port": self.peer_port,
            "upload_port": self.upload_port,
            "type": int(self.config.host_type_enum),
            "idc": h.idc,
            "location": h.location,
            "tpu_slice": h.tpu_slice,
            "tpu_worker_index": h.tpu_worker_index,
            "telemetry": self._telemetry(),
        }

    def _telemetry(self) -> dict:
        try:
            return {"cpu_percent": self._cpu(),
                    "mem_percent": _mem_percent(),
                    "disk_free": _disk_free()}
        except (OSError, KeyError, ValueError, IndexError,
                ZeroDivisionError):
            return {}

    async def start(self) -> None:
        await self.announce_once()
        if self._pending_clock is not None:
            await self.announce_once()
        self._task = asyncio.ensure_future(self._loop())

    async def announce_once(self) -> None:
        body = self.host_wire()
        if self._pending_clock is not None:
            body["clock"] = self._pending_clock
        t0 = self._wall_now()
        try:
            resp = await self.scheduler_client.announce_host(body)
        except Exception as e:
            log.warning("host announce failed", error=str(e))
            return
        t1 = self._wall_now()
        resp = resp if isinstance(resp, dict) else {}
        echo = resp.get("sched_wall")
        if isinstance(echo, (int, float)) and echo > 0:
            self._pending_clock = {"t0": t0, "t1": t1, "echo": float(echo)}
        scorecard = resp.get("scorecard")
        if self.recorder is not None and isinstance(scorecard, dict):
            self.recorder.scorecard_snapshot = {
                "at_wall": round(t1, 3), **scorecard}

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            await self.announce_once()

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
        try:
            await self.scheduler_client.leave_host(self.host_id)
        except Exception:
            pass
