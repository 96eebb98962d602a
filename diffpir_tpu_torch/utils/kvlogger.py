"""Key-value experiment logger with pluggable writers.

The port's own copy of ``diffpir_tpu/utils/kvlogger.py`` (the OpenAI-baselines
logger the reference vendors, ``guided_diffusion/logger.py``): ``logkv`` /
``logkv_mean`` accumulate values per step, ``dumpkvs`` flushes to all
writers (human table, JSON lines, CSV, TensorBoard events), ``profile_kv`` /
``@profile`` time code blocks into ``wait_<name>`` keys, and ``configure``
selects the output directory and formats (environment:
``DIFFPIR_LOG_FORMAT``, comma-separated, default "stdout,log,csv").  Means
are host-local: the trainer logs values already reduced over its batch.
"""

from __future__ import annotations

import contextlib
import csv
import datetime
import functools
import json
import os
import os.path as osp
import tempfile
import time
from collections import defaultdict
from typing import Any, Optional

__all__ = ["configure", "logkv", "logkv_mean", "dumpkvs", "getkvs", "log",
           "profile_kv", "profile", "get_dir", "reset"]

DEBUG, INFO, WARN, ERROR = 10, 20, 30, 40


class HumanOutputFormat:
    def __init__(self, file):
        self.file = file
        self.own = isinstance(file, str)
        if self.own:
            self.file = open(file, "at")

    def writekvs(self, kvs: dict) -> None:
        def fmt(v):
            return f"{v:<8.3g}" if hasattr(v, "__float__") else str(v)

        items = {k: fmt(v) for k, v in sorted(kvs.items())}
        if not items:
            return
        kw = max(map(len, items.keys()))
        vw = max(map(len, items.values()))
        dashes = "-" * (kw + vw + 7)
        lines = [dashes]
        for k, v in items.items():
            lines.append(f"| {k}{' ' * (kw - len(k))} | {v}{' ' * (vw - len(v))} |")
        lines.append(dashes)
        self.file.write("\n".join(lines) + "\n")
        self.file.flush()

    def writeseq(self, seq) -> None:
        self.file.write(" ".join(map(str, seq)) + "\n")
        self.file.flush()

    def close(self):
        if self.own:
            self.file.close()


class JSONOutputFormat:
    def __init__(self, filename: str):
        self.file = open(filename, "at")

    def writekvs(self, kvs: dict) -> None:
        out = {k: (float(v) if hasattr(v, "dtype") or hasattr(v, "__float__")
                   else v) for k, v in kvs.items()}
        self.file.write(json.dumps(out) + "\n")
        self.file.flush()

    def writeseq(self, seq):
        pass

    def close(self):
        self.file.close()


class CSVOutputFormat:
    def __init__(self, filename: str):
        self.filename = filename
        self.keys: list[str] = []
        # resuming into an existing csv: adopt its header so appended rows
        # stay column-aligned (new keys are appended and old rows padded)
        if osp.exists(filename):
            with open(filename) as f:
                first = f.readline().strip()
            if first:
                self.keys = first.split(",")

    def writekvs(self, kvs: dict) -> None:
        extra = sorted(set(kvs.keys()) - set(self.keys))
        if extra:
            self.keys.extend(extra)
            rows = []
            if osp.exists(self.filename):
                with open(self.filename) as f:
                    rows = list(csv.reader(f))[1:]
            with open(self.filename, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(self.keys)
                for r in rows:
                    w.writerow(r + [""] * (len(self.keys) - len(r)))
        with open(self.filename, "a", newline="") as f:
            csv.writer(f).writerow(
                ["" if kvs.get(k) is None else kvs.get(k, "") for k in self.keys])

    def writeseq(self, seq):
        pass

    def close(self):
        pass


# --------------------------------------------------------------------------
# TensorBoard writer (reference ``logger.py TensorBoardOutputFormat``,
# ~lines 150-188).  The reference goes through tensorflow's EventsWriter;
# the Event protos and TFRecord framing are encoded here by hand: scalar
# summaries only, which is all the reference writer emits (simple_value).
# --------------------------------------------------------------------------

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord framing requires."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _pb_bytes(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


class TensorBoardOutputFormat:
    """Scalar-summary event-file writer readable by TensorBoard."""

    def __init__(self, dir: str):
        import socket
        import struct

        os.makedirs(dir, exist_ok=True)
        self.step = 1
        self._struct = struct
        path = osp.join(osp.abspath(dir),
                        f"events.out.tfevents.{int(time.time())}."
                        f"{socket.gethostname()}")
        self.file = open(path, "wb")
        # header event: file_version (Event field 3)
        self._write_event(_pb_bytes(3, b"brain.Event:2"))

    def _write_event(self, body: bytes) -> None:
        st = self._struct
        # Event field 1: wall_time (double)
        rec = st.pack("<B", 0x09) + st.pack("<d", time.time()) + body
        framed = st.pack("<Q", len(rec))
        self.file.write(framed + st.pack("<I", _masked_crc(framed)) + rec
                        + st.pack("<I", _masked_crc(rec)))
        self.file.flush()

    def writekvs(self, kvs: dict) -> None:
        st = self._struct
        values = b"".join(
            _pb_bytes(1, _pb_bytes(1, str(k).encode())  # Value.tag
                      + st.pack("<B", 0x15)             # Value.simple_value
                      + st.pack("<f", float(v)))
            for k, v in kvs.items() if hasattr(v, "__float__"))
        body = (st.pack("<B", 0x10) + _varint(self.step)   # Event.step
                + _pb_bytes(5, values))                    # Event.summary
        self._write_event(body)
        self.step += 1

    def writeseq(self, seq) -> None:
        pass

    def close(self):
        if self.file:
            self.file.close()
            self.file = None


def _make_format(fmt: str, ev_dir: str, suffix: str = ""):
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "stdout":
        import sys

        return HumanOutputFormat(sys.stdout)
    if fmt == "log":
        return HumanOutputFormat(osp.join(ev_dir, f"log{suffix}.txt"))
    if fmt == "json":
        return JSONOutputFormat(osp.join(ev_dir, f"progress{suffix}.json"))
    if fmt == "csv":
        return CSVOutputFormat(osp.join(ev_dir, f"progress{suffix}.csv"))
    if fmt == "tensorboard":
        return TensorBoardOutputFormat(osp.join(ev_dir, f"tb{suffix}"))
    raise ValueError(f"unknown log format {fmt!r}")


class _Logger:
    def __init__(self, dir: Optional[str], formats):
        self.name2val: dict[str, Any] = defaultdict(float)
        self.name2cnt: dict[str, int] = defaultdict(int)
        self.dir = dir
        self.formats = formats
        self.level = INFO

    def logkv(self, key, val):
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        old, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = old * cnt / (cnt + 1) + val / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self):
        out = dict(self.name2val)
        for f in self.formats:
            f.writekvs(self.name2val)
        self.name2val.clear()
        self.name2cnt.clear()
        return out

    def log_seq(self, args, level=INFO):
        if level >= self.level:
            for f in self.formats:
                if isinstance(f, HumanOutputFormat):
                    f.writeseq(map(str, args))

    def close(self):
        for f in self.formats:
            f.close()


_CURRENT: Optional[_Logger] = None


def configure(dir: Optional[str] = None, format_strs: Optional[list[str]] = None):
    """Set up the global logger (reference ``logger.py configure``)."""
    global _CURRENT
    if dir is None:
        dir = osp.join(tempfile.gettempdir(),
                       datetime.datetime.now().strftime("diffpir-%Y-%m-%d-%H-%M-%S-%f"))
    if format_strs is None:
        format_strs = os.environ.get("DIFFPIR_LOG_FORMAT", "stdout,log,csv").split(",")
    formats = [_make_format(f.strip(), dir) for f in format_strs if f.strip()]
    _CURRENT = _Logger(dir, formats)
    return _CURRENT


def _get() -> _Logger:
    global _CURRENT
    if _CURRENT is None:
        configure()
    return _CURRENT


def reset():
    global _CURRENT
    if _CURRENT is not None:
        _CURRENT.close()
    _CURRENT = None


def logkv(key, val):
    _get().logkv(key, val)


def logkv_mean(key, val):
    _get().logkv_mean(key, val)


def dumpkvs():
    return _get().dumpkvs()


def getkvs():
    return dict(_get().name2val)


def log(*args, level=INFO):
    _get().log_seq(args, level)


def get_dir() -> Optional[str]:
    return _get().dir


@contextlib.contextmanager
def profile_kv(scope_name: str):
    """Accumulate wall time under ``wait_<name>`` (reference ``logger.py``)."""
    t0 = time.time()
    try:
        yield
    finally:
        _get().name2val[f"wait_{scope_name}"] += time.time() - t0


def profile(name: str):
    def decorator(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with profile_kv(name):
                return fn(*a, **kw)

        return wrapped

    return decorator
