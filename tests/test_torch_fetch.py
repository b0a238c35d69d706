"""The port's fetchers (`utils/downloads.py`, `utils/bootstrap.py`,
`utils/youtube.py`, `utils/scrapers.py`) and its AES-128 (`utils/aes.py`)
on the CPU, offline: JAX's cases of `tests/test_youtube.py`,
`test_scrapers.py` and `test_bootstrap.py` run against the port, each
result held equal to the JAX package's where both compute one, with
127.0.0.1 servers in place of the network and the downloads mocked.

The AES: bytes equal to the FIPS-197 appendix C.1 vector and to the
`cryptography` package's ECB, CBC and CTR (which the card's machine
does not have)."""

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

from rvc_maker_tpu.utils import bootstrap as jboot
from rvc_maker_tpu.utils import scrapers as jsc
from rvc_maker_tpu.utils import youtube as jyt
from rvc_maker_tpu_torch.utils import aes
from rvc_maker_tpu_torch.utils import bootstrap
from rvc_maker_tpu_torch.utils import downloads
from rvc_maker_tpu_torch.utils import scrapers as sc
from rvc_maker_tpu_torch.utils import youtube as yt
from rvc_maker_tpu_torch.utils.i18n import tr


def _ecb(key, data, decrypt=False):
    """The port's block cipher on each 16-byte block."""
    cipher = aes.AES128(key)
    blocks = np.frombuffer(data, np.uint8).reshape(-1, 16)
    return (cipher.decrypt(blocks) if decrypt else cipher.encrypt(blocks)).tobytes()


def _crypt(key, mode, data, decrypt=False):
    c = Cipher(algorithms.AES(key), mode)
    ctx = c.decryptor() if decrypt else c.encryptor()
    return ctx.update(data) + ctx.finalize()


# ---------------------------------------------------------------- AES-128


def test_aes_fips197_c1_vector():
    key = bytes(range(16))
    plain = bytes.fromhex("00112233445566778899aabbccddeeff")
    cipher = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")
    assert _ecb(key, plain) == cipher
    assert _ecb(key, cipher, decrypt=True) == plain
    # FIPS-197 appendix A.1: the last round key of this key schedule
    assert aes.expand_key(bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c"))[10].tobytes() == \
        bytes.fromhex("d014f9a8c9ee2589e13f0cc8b6630ca6")


@pytest.mark.parametrize("seed", range(4))
def test_aes_ecb_and_cbc_match_cryptography(seed):
    rs = np.random.RandomState(seed)
    key, iv = rs.bytes(16), rs.bytes(16)
    data = rs.bytes(16 * (1 + 97 * seed))
    assert _ecb(key, data) == _crypt(key, modes.ECB(), data)
    assert _ecb(key, data, decrypt=True) == _crypt(key, modes.ECB(), data, decrypt=True)
    assert aes.cbc_decrypt(key, iv, data) == _crypt(key, modes.CBC(iv), data, decrypt=True)
    chained = _crypt(key, modes.CBC(iv), data)
    blocks = np.frombuffer(data, np.uint8).reshape(-1, 16)
    macs = aes.cbc_mac(aes.AES128(key), iv, [blocks, blocks[:1], blocks[: max(1, len(blocks) // 2)]])
    assert macs[0].tobytes() == chained[-16:]
    assert macs[1].tobytes() == chained[:16]
    assert macs[2].tobytes() == chained[16 * (max(1, len(blocks) // 2) - 1):][:16]
    with pytest.raises(ValueError):
        aes.cbc_decrypt(key, iv, data + b"x")
    with pytest.raises(ValueError):
        aes.AES128(key[:15])


@pytest.mark.parametrize("counter,offset,n", [
    (bytes(16), 0, 1000), (b"\x12" * 8 + b"\xff" * 7 + b"\xf0", 0, 777),  # low half wraps
    (b"\xff" * 16, 0, 100), (bytes(range(16)), 16 * 37, 5000)])
def test_aes_ctr_matches_cryptography(counter, offset, n):
    rs = np.random.RandomState(n)
    key, data = rs.bytes(16), rs.bytes(offset + n)
    ref = _crypt(key, modes.CTR(counter), data)
    got = aes.ctr_crypt(aes.AES128(key), counter, data[offset:], offset)
    assert got == ref[offset:]
    with pytest.raises(ValueError):
        aes.ctr_crypt(aes.AES128(key), counter, data, 8)


# ------------------------------------------------------------ downloads


class _RangeHandler(BaseHTTPRequestHandler):
    """Serves CONTENT with Range support, recording each Range asked."""
    CONTENT = bytes(range(256)) * 40   # 10240 bytes
    requests: list = []

    def do_GET(self):
        rng = self.headers.get("Range", "")
        type(self).requests.append(rng)
        start, end = 0, len(self.CONTENT) - 1
        if rng.startswith("bytes="):
            s, _, e = rng[6:].partition("-")
            start = int(s)
            if e:
                end = min(int(e), len(self.CONTENT) - 1)
        if start >= len(self.CONTENT):
            self.send_response(416)
            self.end_headers()
            return
        chunk = self.CONTENT[start:end + 1]
        self.send_response(206 if rng else 200)
        self.send_header("Content-Length", str(len(chunk)))
        self.end_headers()
        self.wfile.write(chunk)

    def log_message(self, *a):
        pass


@pytest.fixture()
def range_server():
    _RangeHandler.requests = []
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _RangeHandler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}/stream"
    httpd.shutdown()
    httpd.server_close()
    t.join(10)


def _closed_url() -> str:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}/x.pth"


def test_download_url_resumes_a_partial_file(tmp_path, range_server):
    out = str(tmp_path / "sub" / "a.bin")
    assert downloads.download_url(range_server, out) == out
    assert open(out, "rb").read() == _RangeHandler.CONTENT
    with open(out + ".partial", "wb") as f:
        f.write(_RangeHandler.CONTENT[:3000])
    downloads.download_url(range_server, out)
    assert _RangeHandler.requests[-1] == "bytes=3000-"
    assert open(out, "rb").read() == _RangeHandler.CONTENT
    assert not os.path.exists(out + ".partial")


def test_download_url_without_a_network_says_so(tmp_path):
    url = _closed_url()
    with pytest.raises(RuntimeError) as got:
        downloads.download_url(url, str(tmp_path / "x.pth"))
    assert str(got.value).startswith(tr("download_disabled") + f" (url={url}: ")


def test_download_huggingface_and_pixeldrain_urls(monkeypatch):
    calls = []
    monkeypatch.setattr(downloads, "download_url", lambda url, out: calls.append((url, out)) or out)
    downloads.download_huggingface("https://huggingface.co/u/r/blob/main/m.pth", "m.pth")
    downloads.download_huggingface("https://huggingface.co/u/r/resolve/main/m.pth", "m.pth")
    downloads.download_pixeldrain("https://pixeldrain.com/u/AbC123/", "p.bin")
    assert [c[0] for c in calls] == ["https://huggingface.co/u/r/blob/main/m.pth?download=true",
                                     "https://huggingface.co/u/r/resolve/main/m.pth",
                                     "https://pixeldrain.com/api/file/AbC123"]


# ---------------------------------------------------------------- youtube


@pytest.mark.parametrize("url,vid", [
    ("https://www.youtube.com/watch?v=dQw4w9WgXcQ", "dQw4w9WgXcQ"),
    ("https://www.youtube.com/watch?v=dQw4w9WgXcQ&t=42s", "dQw4w9WgXcQ"),
    ("https://youtu.be/dQw4w9WgXcQ?si=abc", "dQw4w9WgXcQ"),
    ("https://www.youtube.com/shorts/abcDEF12345", "abcDEF12345"),
    ("https://www.youtube.com/embed/abcDEF12345", "abcDEF12345"),
    ("https://m.youtube.com/watch?v=0123456789_", "0123456789_"),
    ("dQw4w9WgXcQ", "dQw4w9WgXcQ"),
])
def test_extract_video_id(url, vid):
    assert yt.extract_video_id(url) == jyt.extract_video_id(url) == vid


def test_extract_video_id_rejects():
    for bad in ("https://example.com/watch", "not an id", "short"):
        with pytest.raises(ValueError):
            yt.extract_video_id(bad)


def test_is_youtube_url():
    for url, want in (("https://www.youtube.com/watch?v=x", True), ("https://youtu.be/x", True),
                      ("https://music.youtube.com/watch?v=x", True),
                      ("https://drive.google.com/file/d/x", False),
                      ("https://notyoutube.com.evil.io/x", False),
                      ("https://evilyoutube.com/x", False)):
        assert yt.is_youtube_url(url) == jyt.is_youtube_url(url) == want


def test_build_player_request():
    assert yt.build_player_request("dQw4w9WgXcQ") == jyt.build_player_request("dQw4w9WgXcQ")
    url, body, headers = yt.build_player_request("dQw4w9WgXcQ")
    assert url.startswith("https://www.youtube.com/youtubei/v1/player")
    payload = json.loads(body)
    assert payload["videoId"] == "dQw4w9WgXcQ"
    assert payload["context"]["client"]["clientName"] == "ANDROID"
    assert headers["X-Youtube-Client-Name"] == "3"


PLAYER_FIXTURE = {
    "playabilityStatus": {"status": "OK"},
    "streamingData": {"adaptiveFormats": [
        {"itag": 137, "mimeType": 'video/mp4; codecs="avc1"', "bitrate": 4000000,
         "url": "https://v/video"},
        {"itag": 140, "mimeType": 'audio/mp4; codecs="mp4a.40.2"', "bitrate": 130000,
         "url": "https://v/m4a", "contentLength": "1000"},
        {"itag": 251, "mimeType": 'audio/webm; codecs="opus"', "bitrate": 160000,
         "url": "https://v/opus", "contentLength": "900"},
        {"itag": 250, "mimeType": 'audio/webm; codecs="opus"', "bitrate": 70000,
         "url": "https://v/opus-low"},
        {"itag": 777, "mimeType": 'audio/webm; codecs="opus"', "bitrate": 999999999,
         "signatureCipher": "s=..."},  # no direct url: skipped
    ]},
}


def test_select_best_audio():
    fmt = yt.select_best_audio(PLAYER_FIXTURE)
    assert fmt == jyt.select_best_audio(PLAYER_FIXTURE) and fmt["itag"] == 251
    assert yt.format_extension(fmt) == "webm"
    for mime in ('audio/mp4; codecs="mp4a.40.2"', "audio/ogg", ""):
        assert yt.format_extension({"mimeType": mime}) == jyt.format_extension({"mimeType": mime})


def test_select_best_audio_errors():
    with pytest.raises(RuntimeError, match="not playable"):
        yt.select_best_audio({"playabilityStatus": {"status": "LOGIN_REQUIRED", "reason": "age"}})
    with pytest.raises(RuntimeError, match="no direct audio"):
        yt.select_best_audio({"playabilityStatus": {"status": "OK"}, "streamingData": {
            "adaptiveFormats": [{"mimeType": "audio/webm", "signatureCipher": "s=x"}]}})


def test_download_ranged_known_length(tmp_path, range_server):
    out = str(tmp_path / "a.bin")
    yt.download_ranged(range_server, out, total_bytes=10240, chunk_bytes=4096)
    assert open(out, "rb").read() == _RangeHandler.CONTENT
    assert _RangeHandler.requests == ["bytes=0-4095", "bytes=4096-8191", "bytes=8192-10239"]


def test_download_ranged_unknown_length(tmp_path, range_server):
    out = str(tmp_path / "b.bin")
    yt.download_ranged(range_server, out, chunk_bytes=4096)
    assert open(out, "rb").read() == _RangeHandler.CONTENT
    assert _RangeHandler.requests == ["bytes=0-4095", "bytes=4096-8191", "bytes=8192-12287"]


def test_download_audio_flow(tmp_path, range_server, monkeypatch):
    """download_audio with the player response mocked and the stream
    served by the local range server."""
    fixture = json.loads(json.dumps(PLAYER_FIXTURE))
    for f in fixture["streamingData"]["adaptiveFormats"]:
        if f.get("url"):
            f["url"] = range_server
    fixture["streamingData"]["adaptiveFormats"][2]["contentLength"] = "10240"
    monkeypatch.setattr(yt, "fetch_player_response", lambda vid, timeout=30.0: fixture)
    out = yt.download_audio("https://youtu.be/dQw4w9WgXcQ", str(tmp_path / "song"))
    assert out.endswith("song.webm")
    assert open(out, "rb").read() == _RangeHandler.CONTENT


def test_to_wav_gates_on_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr("shutil.which", lambda name: None)
    src = tmp_path / "x.webm"
    src.write_bytes(b"\x1aE\xdf\xa3")
    with pytest.raises(RuntimeError, match="ffmpeg"):
        yt.to_wav(str(src), str(tmp_path / "x.wav"))


# --------------------------------------------------------------- scrapers


def test_gdrive_parse_url():
    for url in ("https://drive.google.com/file/d/ABC123xyz/view",
                "https://drive.google.com/uc?id=QQ11&export=download",
                "https://docs.google.com/document/u/0/d/DOC9/edit",
                "https://example.com/file/d/X/view"):
        assert sc.gdrive_parse_url(url) == jsc.gdrive_parse_url(url)
    assert sc.gdrive_parse_url("https://drive.google.com/file/d/ABC123xyz/view") == \
        ("ABC123xyz", False)


def test_gdrive_confirmation_scrape():
    pages = [
        '<html><form><a href="/uc?export=download&amp;id=F1&amp;confirm=tok">x</a></form></html>',
        '<html><a href="/open?id=BIGFILE99"></a><input type="hidden" name="uuid" value="u-u-i-d">',
        '{"downloadUrl":"https://x.test/a\\u003d1\\u0026b\\u003d2"}']
    for page in pages:
        assert sc.gdrive_url_from_confirmation(page) == jsc.gdrive_url_from_confirmation(page)
    assert sc.gdrive_url_from_confirmation(pages[2]) == "https://x.test/a=1&b=2"
    with pytest.raises(RuntimeError, match="quota exceeded"):
        sc.gdrive_url_from_confirmation('<p class="uc-error-subcaption">quota exceeded</p>')
    with pytest.raises(RuntimeError, match="cannot parse"):
        sc.gdrive_url_from_confirmation("<html></html>")


def test_mediafire_button():
    html = ('<div><a class="input popsok" id="downloadButton" '
            'href="https://download123.mediafire.com/xyz/file.pth">DOWNLOAD</a></div>')
    assert sc.mediafire_direct_url(html) == "https://download123.mediafire.com/xyz/file.pth"
    html_rev = '<a href="https://dl.mediafire.com/q/f.bin" id="downloadButton">x</a>'
    assert sc.mediafire_direct_url(html_rev) == "https://dl.mediafire.com/q/f.bin"
    with pytest.raises(RuntimeError):
        sc.mediafire_direct_url("<html>nothing here</html>")


def test_mega_parse_url():
    for url in ("https://mega.nz/file/AbCd1234#keykeykeykeykey", "https://mega.nz/#!LEGACY42!oldkey"):
        assert sc.mega_parse_url(url) == jsc.mega_parse_url(url)
    assert sc.mega_parse_url("https://mega.nz/file/AbCd1234#keykeykeykeykey") == \
        ("AbCd1234", "keykeykeykeykey")
    with pytest.raises(ValueError):
        sc.mega_parse_url("https://mega.nz/folder/zzz")


def test_mega_key_unwrap_and_a32():
    fk = tuple(range(1, 9))
    assert sc.mega_unwrap_key(fk) == jsc.mega_unwrap_key(fk) == ((1 ^ 5, 2 ^ 6, 3 ^ 7, 4 ^ 8),
                                                                 (5, 6, 0, 0), (7, 8))
    a = (0x01020304, 0xA0B0C0D0)
    assert sc.str_to_a32(sc.a32_to_str(a)) == a
    assert sc.base64_url_decode("QUJD") == b"ABC"
    assert sc.base64_url_decode("QUJDRA") == b"ABCD"


def test_mega_attr_roundtrip():
    k = (11, 22, 33, 44)
    attr = 'MEGA{"n": "model.pth"}'
    padded = attr.encode() + b"\0" * (16 - len(attr) % 16)
    blob = _crypt(sc.a32_to_str(k), modes.CBC(b"\0" * 16), padded)
    assert sc.mega_decrypt_attr(blob, k) == jsc.mega_decrypt_attr(blob, k) == {"n": "model.pth"}
    assert sc.mega_decrypt_attr(b"\x00" * 16, (1, 2, 3, 4)) is False


def _reference_style_mac(data: bytes, k, iv) -> tuple:
    """The reference's MAC loop (meganz.py:117-144), block by block on
    `cryptography`."""
    k_str = sc.a32_to_str(k)
    iv_str = sc.a32_to_str([iv[0], iv[1], iv[0], iv[1]])
    mac_str = b"\0" * 16
    file_size = len(data)
    for start, size in sc.mega_get_chunks(file_size):
        chunk = data[start:start + size]
        enc = Cipher(algorithms.AES(k_str), modes.CBC(iv_str)).encryptor()
        i = 0
        for i in range(0, len(chunk) - 16, 16):
            enc.update(chunk[i:i + 16])
        i = i + 16 if file_size > 16 else 0
        block = chunk[i:i + 16]
        if len(block) % 16:
            block += b"\0" * (16 - len(block) % 16)
        elif not block:
            block = b"\0" * 16
        chunk_mac = enc.update(block)
        mac_str = Cipher(algorithms.AES(k_str), modes.CBC(mac_str)).encryptor().update(chunk_mac)
    fm = sc.str_to_a32(mac_str)
    return (fm[0] ^ fm[1], fm[2] ^ fm[3])


def _mega_fixture(size):
    rs = np.random.RandomState(size % 97)
    plain = rs.bytes(size)
    k = (0xdead, 0xbeef, 0x1234, 0x5678)
    iv = (0x1111, 0x2222, 0, 0)
    ctr0 = (((iv[0] << 32) + iv[1]) << 64).to_bytes(16, "big")
    return plain, _crypt(sc.a32_to_str(k), modes.CTR(ctr0), plain), k, iv


def _reader(data):
    pos = [0]

    def read_chunk(n):
        out = data[pos[0]:pos[0] + n]
        pos[0] += n
        return out

    return read_chunk


@pytest.mark.parametrize("size", [0, 7, 16, 17, 100, 0x20000, 0x20000 + 5, 0x20000 * 3 + 11,
                                  0x20000 * 3 + 16])
def test_mega_decrypt_stream(size, monkeypatch):
    """The plaintext, and the MAC JAX's reference loop gives (up to two
    chunks also with the chunk MACs in groups of one chunk); a MAC off by
    one bit raises.  0x20000 * 3 + 16 ends in a chunk of 16 bytes."""
    plain, cipher, k, iv = _mega_fixture(size)
    meta_mac = _reference_style_mac(plain, k, iv)
    written = []
    sc.mega_decrypt_stream(_reader(cipher), written.append, size, k, iv, meta_mac)
    assert b"".join(written) == plain
    jax_written = []
    jsc.mega_decrypt_stream(_reader(cipher), jax_written.append, size, k, iv, meta_mac)
    assert written == jax_written
    if size <= 0x20000 + 5:
        monkeypatch.setattr(sc, "MAC_GROUP_BYTES", 1)
        sc.mega_decrypt_stream(_reader(cipher), lambda b: None, size, k, iv, meta_mac)
    with pytest.raises(ValueError, match="MAC"):
        sc.mega_decrypt_stream(_reader(cipher), lambda b: None, size, k, iv,
                               (meta_mac[0] ^ 1, meta_mac[1]))


def test_mega_chunk_schedule():
    for size in (0x20000 * 8, 10, 0, 0x100000 * 11 + 3):
        assert list(sc.mega_get_chunks(size)) == list(jsc.mega_get_chunks(size))
    chunks = list(sc.mega_get_chunks(0x20000 * 8))
    assert chunks[0] == (0, 0x20000) and chunks[1][1] == 0x40000
    assert sum(s for _, s in chunks) == 0x20000 * 8


class _MegaFiles(BaseHTTPRequestHandler):
    """The payload host: GET /<name> answers FILES[name]."""
    FILES: dict = {}

    def do_GET(self):
        data = self.FILES[self.path.lstrip("/")]
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


def test_mega_download_end_to_end(tmp_path, monkeypatch):
    """mega_download of a link whose API answer is mocked and whose
    encrypted payload a local server sends: the file under its
    attribute name, byte for byte, and the API request JAX sends."""
    import base64

    plain, cipher, k, iv = _mega_fixture(0x20000 + 999)
    meta_mac = _reference_style_mac(plain, k, iv)
    k_words = list(k)
    file_key = (k_words[0] ^ iv[0], k_words[1] ^ iv[1], k_words[2] ^ meta_mac[0],
                k_words[3] ^ meta_mac[1], iv[0], iv[1], meta_mac[0], meta_mac[1])
    key_b64 = base64.urlsafe_b64encode(sc.a32_to_str(file_key)).decode().rstrip("=")
    attr = b'MEGA{"n": "voice.pth"}'
    attr_blob = _crypt(sc.a32_to_str(k), modes.CBC(b"\0" * 16),
                       attr + b"\0" * (-len(attr) % 16))
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _MegaFiles)
    _MegaFiles.FILES = {"payload": cipher}
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    api_calls = []

    def fake_get(url, *, headers=None, data=None, timeout=60):
        api_calls.append((url, json.loads(data)))
        return json.dumps([{"g": f"http://127.0.0.1:{httpd.server_address[1]}/payload",
                            "s": len(cipher),
                            "at": base64.urlsafe_b64encode(attr_blob).decode().rstrip("=")}
                           ]).encode()

    try:
        monkeypatch.setattr(sc, "_http_get", fake_get)
        out = sc.mega_download(f"https://mega.nz/file/Hand1e42#{key_b64}", str(tmp_path))
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(10)
    assert out == str(tmp_path / "voice.pth")
    assert open(out, "rb").read() == plain
    assert api_calls == [("https://g.api.mega.co.nz/cs?id=0", [{"a": "g", "g": 1, "p": "Hand1e42"}])]


def test_gdrive_and_mediafire_download_through_their_pages(tmp_path, monkeypatch):
    """The page scrape with `_http_get` mocked, the file from the URL it
    finds (download_url mocked): the URLs and paths JAX's give."""
    got = {}
    for mod in (sc, jsc):
        calls = []
        pages = {"https://drive.google.com/uc?id=FID7":
                 '<html><a href="/uc?export=download&amp;id=FID7&amp;confirm=t">x</a></html>',
                 "https://www.mediafire.com/file/abc/model.pth/file":
                 '<a id="downloadButton" href="https://download9.mediafire.com/z/model.pth">x</a>'}
        monkeypatch.setattr(mod, "_http_get", lambda url, **kw: pages[url].encode())
        monkeypatch.setattr(mod, "download_url", lambda url, out: calls.append((url, out)) or out)
        mod.gdrive_download(url="https://drive.google.com/file/d/FID7/view",
                            output=str(tmp_path / "g.pth"))
        mod.mediafire_download("https://www.mediafire.com/file/abc/model.pth/file",
                               output=str(tmp_path))
        got[mod] = calls
    assert got[sc] == got[jsc] == [
        ("https://docs.google.com/uc?export=download&id=FID7&confirm=t", str(tmp_path / "g.pth")),
        ("https://download9.mediafire.com/z/model.pth", str(tmp_path / "model.pth"))]


def test_download_any_dispatch(monkeypatch):
    calls = []
    monkeypatch.setattr(sc, "gdrive_download", lambda **kw: calls.append(("g", kw)) or "g")
    monkeypatch.setattr(sc, "mediafire_download",
                        lambda url, output: calls.append(("mf", url)) or "m")
    monkeypatch.setattr(sc, "mega_download", lambda url, dest_path: calls.append(("mega", url)) or "z")
    monkeypatch.setattr(downloads, "download_url", lambda url, out: calls.append(("url", url, out))
                        or out)
    assert sc.download_any("https://drive.google.com/uc?id=1", "/d") == "g"
    assert sc.download_any("https://www.mediafire.com/file/q/x/file", "/d") == "m"
    assert sc.download_any("https://mega.nz/file/a#b", "/d") == "z"
    assert sc.download_any("https://pixeldrain.com/u/PX1", "/d") == "/d/PX1"
    assert sc.download_any("https://huggingface.co/u/r/resolve/main/m.pth?x=1", "/d") == "/d/m.pth"
    assert [c[0] for c in calls] == ["g", "mf", "mega", "url", "url"]
    assert calls[3][1] == "https://pixeldrain.com/api/file/PX1"


# -------------------------------------------------------------- bootstrap


@pytest.fixture()
def capture_downloads(monkeypatch, tmp_path):
    """The port's and JAX's bootstrap, each with ASSETS in its own
    directory and download_url mocked to write one byte."""
    calls = {"port": [], "jax": []}
    for name, mod, dl in (("port", bootstrap, "rvc_maker_tpu_torch.utils.downloads.download_url"),
                          ("jax", jboot, "rvc_maker_tpu.utils.downloads.download_url")):
        monkeypatch.setattr(mod, "ASSETS", str(tmp_path / name))

        def fake(url, path, _calls=calls[name]):
            _calls.append((url, path))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(b"x")
            return path

        monkeypatch.setattr(dl, fake)
    return calls, tmp_path


def _rel(calls, root):
    return [(u, os.path.relpath(p, root)) for u, p in calls]


def test_methods_of_hybrid():
    for m in ("hybrid[rmvpe+crepe-tiny]", "rmvpe", "hybrid[ pm + fcpe ]"):
        assert bootstrap.methods_of(m) == jboot.methods_of(m)
    assert bootstrap.methods_of("hybrid[rmvpe+crepe-tiny]") == ["rmvpe", "crepe-tiny"]


def test_predictor_registry():
    assert bootstrap.PREDICTOR_FILES == jboot.PREDICTOR_FILES
    assert bootstrap.EMBEDDER_NAMES == jboot.EMBEDDER_NAMES
    assert bootstrap.HF_BASE == jboot.HF_BASE
    assert bootstrap.PREDICTOR_FILES["rmvpe-onnx"] == "rmvpe.onnx"


@pytest.mark.parametrize("method", ["hybrid[rmvpe+fcpe]", "rmvpe-onnx", "crepe-tiny-onnx", "yin"])
def test_ensure_predictor_urls(capture_downloads, method):
    calls, root = capture_downloads
    got = bootstrap.ensure_predictor(method)
    ref = jboot.ensure_predictor(method)
    assert set(got) == set(ref)
    assert _rel(calls["port"], root / "port") == _rel(calls["jax"], root / "jax")
    assert bootstrap.ensure_predictor("yin") == {}


def test_ensure_predictor_skips_existing(capture_downloads):
    calls, _ = capture_downloads
    bootstrap.ensure_predictor("rmvpe")
    n = len(calls["port"])
    bootstrap.ensure_predictor("rmvpe")
    assert len(calls["port"]) == n == 1


def test_ensure_embedder_modes(capture_downloads):
    calls, root = capture_downloads
    for name, mode in (("contentvec_base", "fairseq"), ("spin", "spin"), ("hubert_base", "onnx"),
                       ("korean_hubert_base", "transformers")):
        p = bootstrap.ensure_embedder(name, mode)
        r = jboot.ensure_embedder(name, mode)
        assert os.path.relpath(p, root / "port") == os.path.relpath(r, root / "jax")
    assert _rel(calls["port"], root / "port") == _rel(calls["jax"], root / "jax")
    with pytest.raises(ValueError):
        bootstrap.ensure_embedder("nonsense")
    with pytest.raises(ValueError):
        bootstrap.ensure_embedder("hubert_base", "tflite")


def test_ensure_spk_diarization(capture_downloads):
    calls, root = capture_downloads
    out = bootstrap.ensure_spk_diarization("small")
    jboot.ensure_spk_diarization("small")
    assert out["whisper"].endswith("small.pt") and "hyperparams.yaml" in out
    assert len(calls["port"]) == 6
    assert _rel(calls["port"], root / "port") == _rel(calls["jax"], root / "jax")


def test_ensure_pretrained(capture_downloads):
    calls, root = capture_downloads
    for version, sr, vocoder in (("v2", 48000, "Default"), ("v1", 40000, "RefineGAN")):
        g, d = bootstrap.ensure_pretrained(version, sr, vocoder)
        assert g.endswith(f"G{sr // 1000}k.pth") and d.endswith(f"D{sr // 1000}k.pth")
        jboot.ensure_pretrained(version, sr, vocoder)
    assert _rel(calls["port"], root / "port") == _rel(calls["jax"], root / "jax")


def test_bootstrap_without_a_network_names_the_file(monkeypatch, tmp_path):
    monkeypatch.setattr(bootstrap, "ASSETS", str(tmp_path))
    monkeypatch.setattr(bootstrap, "HF_BASE", _closed_url().rsplit("/", 1)[0] + "/")
    with pytest.raises(RuntimeError) as got:
        bootstrap.ensure_predictor("rmvpe")
    assert f"place the file at {tmp_path / 'models' / 'predictors' / 'rmvpe.pt'}" in str(got.value)
