"""Scraping downloaders: Google Drive, MediaFire, mega.nz (a copy of JAX
`utils/scrapers.py`; reference main/tools/{gdown,mediafire,meganz}.py).

Stdlib HTTP (urllib), and mega's ciphers (AES-CBC for the attributes,
AES-CTR for the payload and the chunked CBC-MAC) on the repo's own
AES-128, `utils/aes.py`, in place of JAX's `cryptography`.  The pure
logic (URL and id parsing, confirmation-page scraping, mega's key
unwrap, the chunked decrypt and MAC) is kept apart from the transport,
so it is tested offline; without a network the entry points raise an
error that says so.  Host work only.
"""

from __future__ import annotations

import base64
import json
import os
import re
import struct
import urllib.error
import urllib.parse
import urllib.request

import numpy as np

from . import aes
from .downloads import download_url

_UA = "Mozilla/5.0 (Macintosh; Intel Mac OS X 10_12_6)"


def _http_get(url: str, *, headers=None, data=None, timeout=60) -> bytes:
    req = urllib.request.Request(url, data=data,
                                 headers={"User-Agent": _UA,
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read()
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise RuntimeError(f"network unavailable for {url}: {e}") from e


# ---------------------------------------------------------------------------
# Google Drive (reference tools/gdown.py)
# ---------------------------------------------------------------------------

_GDRIVE_PATTERNS = (
    r"^/file/d/(.*?)/(edit|view)$",
    r"^/file/u/[0-9]+/d/(.*?)/(edit|view)$",
    r"^/document/d/(.*?)/(edit|htmlview|view)$",
    r"^/document/u/[0-9]+/d/(.*?)/(edit|htmlview|view)$",
    r"^/presentation/d/(.*?)/(edit|htmlview|view)$",
    r"^/presentation/u/[0-9]+/d/(.*?)/(edit|htmlview|view)$",
    r"^/spreadsheets/d/(.*?)/(edit|htmlview|view)$",
    r"^/spreadsheets/u/[0-9]+/d/(.*?)/(edit|htmlview|view)$",
)


def gdrive_parse_url(url: str):
    """-> (file_id | None, is_download_link)  (gdown.py:17-30)."""
    parsed = urllib.parse.urlparse(url)
    is_download_link = parsed.path.endswith("/uc")
    if parsed.hostname not in ("drive.google.com", "docs.google.com"):
        return None, is_download_link
    file_id = urllib.parse.parse_qs(parsed.query).get("id", [None])[0]
    if file_id is None:
        for pattern in _GDRIVE_PATTERNS:
            m = re.match(pattern, parsed.path)
            if m:
                file_id = m.group(1)
                break
    return file_id, is_download_link


def gdrive_url_from_confirmation(contents: str) -> str:
    """Extract the real download URL from Drive's interstitial page
    (gdown.py:32-44)."""
    for pattern in (r'href="(\/uc\?export=download[^"]+)',
                    r'href="/open\?id=([^"]+)"',
                    r'"downloadUrl":"([^"]+)'):
        m = re.search(pattern, contents)
        if not m:
            continue
        url = m.group(1)
        if pattern == r'href="/open\?id=([^"]+)"':
            uuid = re.search(
                r'<input\s+type="hidden"\s+name="uuid"\s+value="([^"]+)"',
                contents)
            if uuid is None:
                raise ValueError("drive page: no uuid field")
            return ("https://drive.usercontent.google.com/download?id="
                    + url + "&confirm=t&uuid=" + uuid.group(1))
        if pattern == r'"downloadUrl":"([^"]+)':
            return url.replace("\\u003d", "=").replace("\\u0026", "&")
        return "https://docs.google.com" + url.replace("&amp;", "&")
    m = re.search(r'<p class="uc-error-subcaption">(.*)</p>', contents)
    if m:
        raise RuntimeError(m.group(1))
    raise RuntimeError("cannot parse the Google Drive confirmation page "
                       "(permission / quota?)")


def gdrive_download(url: str = None, id: str = None, output: str = None) -> str:
    if (id is None) == (url is None):
        raise ValueError("pass exactly one of url=, id=")
    if id is not None:
        url = f"https://drive.google.com/uc?id={id}"
    file_id, is_download = gdrive_parse_url(url)
    if file_id is not None:
        url = f"https://drive.google.com/uc?id={file_id}"
    page = _http_get(url).decode("utf-8", "replace")
    if "Content-Disposition" not in page[:200] and "<html" in page[:2000].lower():
        url = gdrive_url_from_confirmation(page)
    out = output or (file_id or "gdrive_file")
    return download_url(url, out)


# ---------------------------------------------------------------------------
# MediaFire (reference tools/mediafire.py)
# ---------------------------------------------------------------------------

def mediafire_direct_url(page_html: str) -> str:
    """The download button's href (mediafire.py:16)."""
    m = re.search(
        r'<a[^>]*\bid="downloadButton"[^>]*\bhref="([^"]+)"', page_html) \
        or re.search(
        r'<a[^>]*\bhref="([^"]+)"[^>]*\bid="downloadButton"', page_html)
    if not m:
        raise RuntimeError("cannot find downloadButton on the MediaFire page")
    return m.group(1)


def mediafire_download(url: str, output: str = None,
                       filename: str = None) -> str:
    if not filename:
        filename = url.rstrip("/").split("/")[-2]
    out = os.path.join(output or ".", filename)
    page = _http_get(url).decode("utf-8", "replace")
    return download_url(mediafire_direct_url(page), out)


# ---------------------------------------------------------------------------
# mega.nz (reference tools/meganz.py) — AES-CTR payload + chunked CBC-MAC
# ---------------------------------------------------------------------------

def base64_url_decode(data: str) -> bytes:
    data += "=="[(2 - len(data) * 3) % 4:]
    for s, r in (("-", "+"), ("_", "/"), (",", "")):
        data = data.replace(s, r)
    return base64.b64decode(data)


def str_to_a32(b) -> tuple:
    if isinstance(b, str):
        b = b.encode("latin-1")
    if len(b) % 4:
        b += b"\0" * (4 - len(b) % 4)
    return struct.unpack(">%dI" % (len(b) / 4), b)


def a32_to_str(a) -> bytes:
    return struct.pack(">%dI" % len(a), *a)


def mega_unwrap_key(file_key) -> tuple:
    """(k, iv, meta_mac) from the 8-word node key (meganz.py:90-94)."""
    k = (file_key[0] ^ file_key[4], file_key[1] ^ file_key[5],
         file_key[2] ^ file_key[6], file_key[3] ^ file_key[7])
    iv = file_key[4:6] + (0, 0)
    meta_mac = file_key[6:8]
    return k, iv, meta_mac


def mega_decrypt_attr(attr: bytes, k) -> dict | bool:
    """CBC-decrypt the attribute block; MEGA{...} JSON (meganz.py:40-43)."""
    plain = aes.cbc_decrypt(a32_to_str(k), b"\0" * 16, attr).decode("latin-1").rstrip("\0")
    return json.loads(plain[4:]) if plain[:6] == 'MEGA{"' else False


def mega_get_chunks(size: int):
    """MEGA's growing chunk schedule (meganz.py:28-38)."""
    p, s = 0, 0x20000
    while p + s < size:
        yield (p, s)
        p += s
        if s < 0x100000:
            s += 0x20000
    yield (p, size - p)


def _mac_blocks(chunk: bytes, file_size: int) -> np.ndarray:
    """The blocks one chunk's CBC-MAC reads (meganz.py:117-139): every
    16 bytes but the last piece, then that piece zero-padded.  A final
    chunk of at most 16 bytes in a longer file leaves the reference's
    last block empty; a zero block stands in for it, as in JAX."""
    i = 0
    body = range(0, len(chunk) - 16, 16)
    if len(body):
        i = body[-1]
    i = i + 16 if file_size > 16 else 0
    n_body = len(body)
    block = chunk[i:i + 16]
    block += b"\0" * ((16 - len(block) % 16) % 16 if block else 16)
    return np.frombuffer(chunk[:16 * n_body] + block, np.uint8).reshape(-1, 16)


# chunks held for one side-by-side pass of their CBC-MACs: a chain is
# sequential within a chunk (up to 65,536 blocks), and the chunks' chains
# are independent
MAC_GROUP_BYTES = 64 << 20


def mega_decrypt_stream(read_chunk, write_chunk, file_size: int, k, iv,
                        meta_mac) -> None:
    """Decrypt a mega payload chunk by chunk and verify the meta-MAC
    (meganz.py:112-144: an AES-CTR data stream; per chunk a CBC-MAC from
    iv||iv, folded by a CBC-MAC over the chunk MACs).

    read_chunk(n) -> bytes of ciphertext; write_chunk(bytes) takes the
    plaintext, chunk by chunk.  The CTR blocks of a chunk decrypt at once;
    the chunk MACs of up to MAC_GROUP_BYTES of chunks run side by side.
    Raises ValueError on a MAC mismatch."""
    k_str = a32_to_str(k)
    cipher = aes.AES128(k_str)
    counter = (((iv[0] << 32) + iv[1]) << 64).to_bytes(16, "big")
    iv_str = a32_to_str([iv[0], iv[1], iv[0], iv[1]])
    mac = np.zeros(16, np.uint8)
    lanes, held = [], 0

    def fold(mac):
        for chunk_mac in aes.cbc_mac(cipher, iv_str, lanes):
            mac = cipher.encrypt((mac ^ chunk_mac)[None])[0]
        return mac

    for start, chunk_size in mega_get_chunks(file_size):
        chunk = aes.ctr_crypt(cipher, counter, read_chunk(chunk_size), start)
        write_chunk(chunk)
        lanes.append(_mac_blocks(chunk, file_size))
        held += len(chunk)
        if held >= MAC_GROUP_BYTES:
            mac, lanes, held = fold(mac), [], 0
    if lanes:
        mac = fold(mac)

    file_mac = str_to_a32(mac.tobytes())
    if (file_mac[0] ^ file_mac[1], file_mac[2] ^ file_mac[3]) != tuple(meta_mac):
        raise ValueError("mega MAC mismatch — corrupted download")


def mega_parse_url(url: str):
    """-> (file_handle, file_key_b64) (meganz.py:152-158)."""
    if "/file/" in url:
        url = url.replace(" ", "")
        ids = re.findall(r"\W\w{8}\W", url)
        if not ids:
            raise ValueError(f"cannot find a file id in {url!r}")
        file_id = ids[0][1:-1]
        rest = url[re.search(re.escape(file_id), url).end() + 1:]
        parts = f"{file_id}!{rest}".split("!")
    elif "!" in url:
        parts = re.findall(r"/#!(.*)", url)[0].split("!")
    else:
        raise ValueError(f"not a mega file URL: {url!r}")
    return parts[0], parts[1]


def mega_download(url: str, dest_path: str = None,
                  dest_filename: str = None) -> str:
    handle, key_b64 = mega_parse_url(url)
    file_key = str_to_a32(base64_url_decode(key_b64))
    k, iv, meta_mac = mega_unwrap_key(file_key)

    api = "https://g.api.mega.co.nz/cs"
    resp = _http_get(api + "?id=0",
                     data=json.dumps([{"a": "g", "g": 1,
                                       "p": handle}]).encode())
    file_data = json.loads(resp)[0]
    if not isinstance(file_data, dict) or "g" not in file_data:
        raise RuntimeError("mega: file not accessible")
    attribs = mega_decrypt_attr(base64_url_decode(file_data["at"]), k)
    name = dest_filename or (attribs["n"] if attribs else handle)
    out = os.path.join(dest_path or ".", name)

    req = urllib.request.Request(file_data["g"], headers={"User-Agent": _UA})
    with urllib.request.urlopen(req, timeout=120) as r, \
            open(out + ".partial", "wb") as f:
        mega_decrypt_stream(r.read, f.write, int(file_data["s"]), k, iv,
                            meta_mac)
    os.replace(out + ".partial", out)
    return out


# ---------------------------------------------------------------------------
# dispatcher (reference downloads models by URL shape, app.py downloads tab)
# ---------------------------------------------------------------------------

def download_any(url: str, output: str = ".") -> str:
    """Route a URL to the right backend by host."""
    from .downloads import download_huggingface, download_pixeldrain

    host = urllib.parse.urlparse(url).hostname or ""
    if "drive.google.com" in host or "docs.google.com" in host:
        return gdrive_download(url=url, output=os.path.join(
            output, "gdrive_file"))
    if "mediafire.com" in host:
        return mediafire_download(url, output=output)
    if "mega.nz" in host or "mega.co.nz" in host:
        return mega_download(url, dest_path=output)
    if "pixeldrain.com" in host:
        return download_pixeldrain(url, os.path.join(
            output, url.rstrip("/").split("/")[-1]))
    if "huggingface.co" in host:
        return download_huggingface(url, os.path.join(
            output, url.split("/")[-1].split("?")[0]))
    return download_url(url, os.path.join(output, url.split("/")[-1]))
