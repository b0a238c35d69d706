"""A loopback stand-in for the Edge read-aloud service, shared by the
port's TTS tests (tests/test_torch_tts.py, tests/test_torch_app.py) and
chip_smoke.py's phase 13, so that speech synthesis runs with no network.
It imports nothing of the JAX package."""

import json

import numpy as np


class FakeReadAloudServer:
    """A loopback stand-in for the Edge read-aloud service (the JAX
    package's tests/test_tts.py:108, framed by the port's utils/ws.py):
    one connection at a time, it answers speech.config + ssml with
    turn.start, the audio in `chunks` binary messages, one word boundary
    and turn.end.  `requests` holds every client text message, parsed."""

    def __init__(self, audio: bytes, chunks: int = 3):
        import socket
        import threading

        self.audio, self.chunks, self.requests = audio, chunks, []
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self.url = f"ws://127.0.0.1:{self.port}/tts"
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        import base64
        import hashlib
        import struct

        from rvc_maker_tpu_torch.utils import edge_tts_client as etc
        from rvc_maker_tpu_torch.utils import ws

        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            try:
                buf = b""
                while b"\r\n\r\n" not in buf:
                    buf += conn.recv(4096)
                key = next(line.split(b":", 1)[1].strip().decode()
                           for line in buf.split(b"\r\n")
                           if line.lower().startswith(b"sec-websocket-key:"))
                accept = base64.b64encode(hashlib.sha1(
                    (key + ws._WS_GUID).encode()).digest()).decode()
                conn.sendall(("HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
                              f"Connection: Upgrade\r\nSec-WebSocket-Accept: {accept}\r\n\r\n"
                              ).encode())
                for _ in range(2):                     # speech.config, then ssml
                    op, _, payload = ws.decode_frame(conn)
                    assert op == ws.OP_TEXT
                    self.requests.append(etc.parse_text_message(payload.decode()))

                def text(s):
                    conn.sendall(ws.encode_frame(ws.OP_TEXT, s.encode(), mask=False))

                text("X-RequestId:r\r\nPath:turn.start\r\n\r\n{}")
                step = max(1, len(self.audio) // self.chunks)
                head = "X-RequestId:r\r\nContent-Type:audio/x\r\nPath:audio\r\n"
                for i in range(0, len(self.audio), step):
                    conn.sendall(ws.encode_frame(
                        ws.OP_BINARY, struct.pack("!H", len(head)) + head.encode()
                        + self.audio[i:i + step], mask=False))
                meta = {"Metadata": [{"Type": "WordBoundary", "Data": {
                    "Offset": 500000, "Duration": 1000000, "text": {"Text": "hello"}}}]}
                text("X-RequestId:r\r\nPath:audio.metadata\r\n\r\n" + json.dumps(meta))
                text("X-RequestId:r\r\nPath:turn.end\r\n\r\n{}")
                try:
                    ws.decode_frame(conn)              # the client's close, or EOF
                except Exception:  # noqa: BLE001 — the exchange is over either way
                    pass
            except Exception:  # noqa: BLE001 — a broken exchange: the client sees it
                pass
            finally:
                conn.close()

    def close(self):
        import socket

        try:
            self.sock.shutdown(socket.SHUT_RDWR)       # wakes the accept()
        except OSError:
            pass
        self.sock.close()
        self.thread.join(10)


def pcm_wav_bytes(audio: np.ndarray, sr: int = 24000) -> bytes:
    """16-bit RIFF bytes of `audio`, the read-aloud PCM format's stream."""
    import io

    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, sr, (np.clip(audio, -1, 1) * 32767).astype(np.int16))
    return buf.getvalue()
