"""Wire protocol for the fleet tier — length-prefixed JSON/npz frames
(torch port of ``repro/fleet/wire.py``).

Everything the dispatcher and its workers exchange is one ``Message``: a
``kind`` tag, a small metadata dict, and zero or more numpy arrays. On
the wire that is a single length-prefixed frame, byte for byte the
reference's::

    u32 frame_len | u32 header_len | codec byte | header | npz body

* **header** — the metadata dict. The port writes JSON (codec ``J``): it
  imports the standard library only. A msgpack header (codec ``M``)
  raises ``WireError`` with the reference's message, as the reference
  does where msgpack is not installed; a reference without msgpack, or
  with its codec turned off, writes JSON, and its frames load here.
* **body** — the arrays as one uncompressed ``.npz`` (``numpy.savez``),
  loaded with ``allow_pickle=False``: no code, only data, crosses the
  socket. Omitted entirely for array-free frames (acks, pings).

``put_blocks`` takes numpy arrays or torch tensors: a tensor is copied to
the host explicitly (on the card, that copy is the one sync of a
submit), and a bf16 tensor goes out as raw two-byte records (``|V2``),
as numpy writes an ``ml_dtypes`` bfloat16 array and as the port's fold
journal stores one (``serve.journal.host_block``). ``tensor_of`` reads an
array back as a tensor, ``|V2`` records (the only two-byte void the
protocol carries) as bf16.

``Channel`` wraps any connected stream socket (TCP or a ``socketpair``)
with blocking ``send``/``recv``, a ``poll`` for batch-draining readers,
and the reference's frame-size cap (``MAX_FRAME``, 2 GiB: a frame's
length is a u32). Blocked (per-layer tuple) arrays flatten to ``name.0,
name.1, ...`` entries via ``put_blocks``/``get_blocks`` so the frame
format stays a flat dict.

Frames are the *only* coupling between fleet processes — workers and
dispatcher share no memory, which is what makes the tier's failure model
(kill a worker, replay its in-flight requests elsewhere) tractable.
"""
from __future__ import annotations

import io
import json
import select
import socket
import struct
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve.journal import host_block

__all__ = ["Message", "Channel", "WireError", "put_blocks", "get_blocks",
           "connect", "listen"]

_LEN = struct.Struct(">I")
MAX_FRAME = 1 << 31               # hard cap: refuse absurd frames early


class WireError(ConnectionError):
    """Peer closed or the stream is corrupt — callers treat the channel
    as dead (the dispatcher's failure-rerouting trigger)."""


class Message(NamedTuple):
    kind: str
    meta: Dict[str, Any]
    arrays: Dict[str, np.ndarray]


def _encode_header(meta: Dict[str, Any]) -> bytes:
    return b"J" + json.dumps(meta).encode("utf-8")


def _decode_header(raw: bytes) -> Dict[str, Any]:
    codec, body = raw[:1], raw[1:]
    if codec == b"M":
        raise WireError("peer sent a msgpack header but msgpack is "
                        "not installed here; reinstall or let the "
                        "peer fall back to JSON")
    if codec == b"J":
        return json.loads(body.decode("utf-8"))
    raise WireError(f"unknown header codec {codec!r}")


def _encode_arrays(arrays: Dict[str, np.ndarray]) -> bytes:
    if not arrays:
        return b""
    buf = io.BytesIO()
    np.savez(buf, **{k: host_array(v) for k, v in arrays.items()})
    return buf.getvalue()


def encode_frame(kind: str, meta: Optional[Dict[str, Any]] = None,
                 arrays: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    """One whole frame: ``u32 frame_len | u32 header_len | header | body``
    (the header's first byte its codec)."""
    header = _encode_header({"kind": kind, **(meta or {})})
    body = _encode_arrays(arrays or {})
    return _LEN.pack(4 + len(header) + len(body)) \
        + _LEN.pack(len(header)) + header + body


def _decode_arrays(raw: bytes) -> Dict[str, np.ndarray]:
    if not raw:
        return {}
    with np.load(io.BytesIO(raw), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def host_array(value) -> np.ndarray:
    """A host numpy array of one block: a tensor copied off its device
    (bf16 as ``|V2`` records), an array as it is."""
    if isinstance(value, torch.Tensor):
        a, dtype = host_block(value)
        return a.view("V2") if dtype == "bfloat16" else a
    return np.asarray(value)


def to_host(value):
    """``host_array`` of a dense value or of each block of a tuple."""
    if isinstance(value, (tuple, list)):
        return tuple(host_array(b) for b in value)
    return host_array(value)


def tensor_of(a, device=None) -> torch.Tensor:
    """A received array as a tensor on ``device`` (default: the CPU);
    ``|V2`` records and ``ml_dtypes`` bfloat16 arrays come back as bf16."""
    a = np.asarray(a)
    if a.dtype == np.dtype("V2") or a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t if device is None else t.to(device)


def put_blocks(arrays: Dict[str, np.ndarray], meta: Dict[str, Any],
               name: str, value) -> None:
    """Store a dense array or a tuple of per-layer blocks under ``name``
    (blocks become ``name.i``; ``meta[name_blocks]`` records the count).
    Tensors are copied to the host here."""
    if value is None:
        return
    if isinstance(value, (tuple, list)):
        meta[f"{name}_blocks"] = len(value)
        for i, b in enumerate(value):
            arrays[f"{name}.{i}"] = host_array(b)
    else:
        arrays[name] = host_array(value)


def get_blocks(msg: Message, name: str):
    """Inverse of ``put_blocks`` (None when absent); numpy arrays."""
    nb = msg.meta.get(f"{name}_blocks")
    if nb is not None:
        return tuple(msg.arrays[f"{name}.{i}"] for i in range(nb))
    return msg.arrays.get(name)


class Channel:
    """One duplex frame stream over a connected socket."""

    def __init__(self, sock: socket.socket, *, name: str = ""):
        self.sock = sock
        self.name = name
        self._closed = False
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass                  # socketpair / AF_UNIX: no Nagle to kill

    # -- sending -----------------------------------------------------------
    def send(self, kind: str, meta: Optional[Dict[str, Any]] = None,
             arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
        self.send_frame(encode_frame(kind, meta, arrays), kind)

    def send_frame(self, frame: bytes, kind: str = "frame") -> None:
        """Send one frame ``encode_frame`` built (a broadcast encodes its
        frame once for every channel)."""
        try:
            self.sock.sendall(frame)
        except (OSError, ValueError) as e:
            raise WireError(f"send({kind}) on dead channel "
                            f"{self.name or id(self)}: {e}") from e

    # -- receiving ---------------------------------------------------------
    def _recv_exact(self, count: int) -> bytes:
        chunks = []
        while count:
            try:
                chunk = self.sock.recv(min(count, 1 << 20))
            except (OSError, ValueError) as e:
                raise WireError(f"recv on dead channel "
                                f"{self.name or id(self)}: {e}") from e
            if not chunk:
                raise WireError(f"peer closed channel "
                                f"{self.name or id(self)}")
            chunks.append(chunk)
            count -= len(chunk)
        return b"".join(chunks)

    def recv(self, timeout: Optional[float] = None) -> Message:
        """Block for the next frame (raises ``socket.timeout`` after
        ``timeout`` seconds, ``WireError`` on EOF/corruption)."""
        prev = self.sock.gettimeout()
        try:
            self.sock.settimeout(timeout)
            (frame_len,) = _LEN.unpack(self._recv_exact(4))
            if not 4 <= frame_len <= MAX_FRAME:
                raise WireError(f"corrupt frame length {frame_len}")
            payload = self._recv_exact(frame_len)
        finally:
            try:
                self.sock.settimeout(prev)
            except OSError:
                pass
        (header_len,) = _LEN.unpack(payload[:4])
        if not 1 <= header_len <= frame_len - 4:
            raise WireError(f"corrupt header length {header_len}")
        meta = _decode_header(payload[4:4 + header_len])
        arrays = _decode_arrays(payload[4 + header_len:])
        kind = meta.pop("kind", None)
        if not isinstance(kind, str):
            raise WireError("frame header carries no kind")
        return Message(kind=kind, meta=meta, arrays=arrays)

    def poll(self, timeout: float = 0.0) -> bool:
        """True when a frame (or EOF) is ready to read without blocking."""
        if self._closed:
            return False
        r, _, _ = select.select([self.sock], [], [], timeout)
        return bool(r)

    def fileno(self) -> int:
        return self.sock.fileno()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self.sock.close()


def listen(host: str = "127.0.0.1", port: int = 0
           ) -> Tuple[socket.socket, int]:
    """Bind a listener (port 0 → ephemeral); returns (socket, port)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(64)
    return srv, srv.getsockname()[1]


def connect(host: str, port: int, *, timeout: float = 30.0,
            name: str = "") -> Channel:
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(None)
    return Channel(sock, name=name)
