"""Minimal RFC 6455 WebSocket client on the Python stdlib.

A copy of `rvc_maker_tpu/utils/ws.py`.  No ``websockets``/``aiohttp``
is needed: the Edge-TTS protocol
(utils/edge_tts_client.py) needs a plain client-side WebSocket:
handshake, masked client frames, fragmented server frames, ping/pong,
close.  Synchronous and blocking — TTS synthesis is a short-lived
request/response exchange, not a long-lived duplex stream.

Supports ``wss://`` (ssl-wrapped) and ``ws://`` (plain — used by the
offline test suite's loopback fake server).
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import ssl
import struct
from urllib.parse import urlparse

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


class WebSocketError(RuntimeError):
    pass


def encode_frame(opcode: int, payload: bytes, *, fin: bool = True,
                 mask: bool = True, mask_key: bytes | None = None) -> bytes:
    """Encode one frame. Client frames MUST be masked (RFC 6455 §5.3)."""
    b0 = (0x80 if fin else 0) | (opcode & 0x0F)
    n = len(payload)
    if n < 126:
        header = struct.pack("!BB", b0, (0x80 if mask else 0) | n)
    elif n < (1 << 16):
        header = struct.pack("!BBH", b0, (0x80 if mask else 0) | 126, n)
    else:
        header = struct.pack("!BBQ", b0, (0x80 if mask else 0) | 127, n)
    if not mask:
        return header + payload
    key = mask_key if mask_key is not None else os.urandom(4)
    masked = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return header + key + masked


def _read_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise WebSocketError("connection closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def decode_frame(sock) -> tuple[int, bool, bytes]:
    """Read one frame from the socket -> (opcode, fin, payload)."""
    b0, b1 = _read_exact(sock, 2)
    fin = bool(b0 & 0x80)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack("!H", _read_exact(sock, 2))
    elif n == 127:
        (n,) = struct.unpack("!Q", _read_exact(sock, 8))
    key = _read_exact(sock, 4) if masked else None
    payload = _read_exact(sock, n)
    if key:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return opcode, fin, payload


class WebSocket:
    """Blocking client WebSocket with automatic ping/pong + fragment
    reassembly.  ``receive()`` yields complete text (str) or binary
    (bytes) messages."""

    def __init__(self, url: str, headers: dict[str, str] | None = None,
                 timeout: float = 30.0):
        u = urlparse(url)
        if u.scheme not in ("ws", "wss"):
            raise ValueError(f"not a websocket url: {url}")
        host = u.hostname
        port = u.port or (443 if u.scheme == "wss" else 80)
        raw = socket.create_connection((host, port), timeout=timeout)
        if u.scheme == "wss":
            ctx = ssl.create_default_context()
            raw = ctx.wrap_socket(raw, server_hostname=host)
        self.sock = raw
        self._closed = False
        self._handshake(u, headers or {})

    def _handshake(self, u, headers: dict[str, str]) -> None:
        key = base64.b64encode(os.urandom(16)).decode()
        path = u.path or "/"
        if u.query:
            path += "?" + u.query
        default_port = 443 if u.scheme == "wss" else 80
        host_hdr = u.hostname if (u.port or default_port) == default_port \
            else f"{u.hostname}:{u.port}"
        lines = [
            f"GET {path} HTTP/1.1",
            f"Host: {host_hdr}",
            "Upgrade: websocket",
            "Connection: Upgrade",
            f"Sec-WebSocket-Key: {key}",
            "Sec-WebSocket-Version: 13",
        ]
        for k, v in headers.items():
            lines.append(f"{k}: {v}")
        self.sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())

        # read response head
        buf = bytearray()
        while b"\r\n\r\n" not in buf:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise WebSocketError("handshake: connection closed")
            buf.extend(chunk)
            if len(buf) > 65536:
                raise WebSocketError("handshake: oversized response")
        head, rest = bytes(buf).split(b"\r\n\r\n", 1)
        status = head.split(b"\r\n")[0].decode(errors="replace")
        if " 101" not in status:
            raise WebSocketError(f"handshake rejected: {status}")
        accept = None
        for line in head.split(b"\r\n")[1:]:
            k, _, v = line.decode(errors="replace").partition(":")
            if k.strip().lower() == "sec-websocket-accept":
                accept = v.strip()
        want = base64.b64encode(
            hashlib.sha1((key + _WS_GUID).encode()).digest()).decode()
        if accept != want:
            raise WebSocketError("handshake: bad Sec-WebSocket-Accept")
        self._pending = rest  # bytes already read past the handshake

    def _recv_frame(self):
        if self._pending:
            # splice pre-read bytes back in front of the socket
            sock, pend = self.sock, self._pending

            class _Spliced:
                def __init__(self):
                    self.buf = pend

                def recv(self, n):
                    if self.buf:
                        out, self.buf = self.buf[:n], self.buf[n:]
                        return out
                    return sock.recv(n)

            spl = _Spliced()
            frame = decode_frame(spl)
            self._pending = spl.buf
            return frame
        return decode_frame(self.sock)

    def send_text(self, text: str) -> None:
        self.sock.sendall(encode_frame(OP_TEXT, text.encode()))

    def send_binary(self, data: bytes) -> None:
        self.sock.sendall(encode_frame(OP_BINARY, data))

    def receive(self):
        """Next complete message: str for text, bytes for binary.
        Returns None on clean close."""
        opcode = None
        parts: list[bytes] = []
        while True:
            op, fin, payload = self._recv_frame()
            if op == OP_PING:
                self.sock.sendall(encode_frame(OP_PONG, payload))
                continue
            if op == OP_PONG:
                continue
            if op == OP_CLOSE:
                if not self._closed:
                    try:
                        self.sock.sendall(encode_frame(OP_CLOSE, payload[:2]))
                    except OSError:
                        pass
                    self._closed = True
                return None
            if op in (OP_TEXT, OP_BINARY):
                opcode = op
                parts = [payload]
            elif op == OP_CONT:
                if opcode is None:
                    raise WebSocketError("continuation without start frame")
                parts.append(payload)
            else:
                raise WebSocketError(f"unexpected opcode {op}")
            if fin:
                data = b"".join(parts)
                return data.decode() if opcode == OP_TEXT else data

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self.sock.sendall(encode_frame(OP_CLOSE, struct.pack("!H", 1000)))
            except OSError:
                pass
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
