"""Plain-HTTP downloads (a copy of JAX `utils/downloads.py`; reference
main/tools/huggingface.py and the pixeldrain downloader).

HuggingFace direct links, the pixeldrain API and generic URLs, streamed
with urllib and resumed from a `.partial` file.  The scraping
downloaders (Google Drive, MediaFire, mega.nz) are `utils/scrapers.py`.
Every entry point raises an error that says what to do when the network
is unreachable.  Host work only.
"""

from __future__ import annotations

import logging
import os
import urllib.error
import urllib.request

from .i18n import tr

logger = logging.getLogger(__name__)

CHUNK = 1 << 20


def download_url(url: str, output_path: str, *, resume: bool = True) -> str:
    """Stream a URL to a file with resume support. Returns output_path."""
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    tmp = output_path + ".partial"
    start = os.path.getsize(tmp) if (resume and os.path.exists(tmp)) else 0
    req = urllib.request.Request(url)
    if start:
        req.add_header("Range", f"bytes={start}-")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            mode = "ab" if start and r.status == 206 else "wb"
            with open(tmp, mode) as f:
                while True:
                    buf = r.read(CHUNK)
                    if not buf:
                        break
                    f.write(buf)
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise RuntimeError(f"{tr('download_disabled')} (url={url}: {e})") from e
    os.replace(tmp, output_path)
    logger.info("downloaded %s -> %s", url, output_path)
    return output_path


def download_huggingface(repo_url_or_file: str, output_path: str) -> str:
    """Direct HuggingFace file download (reference tools/huggingface.py:5-25
    follows the resolve/ URL scheme)."""
    url = repo_url_or_file
    if "/resolve/" not in url and "huggingface.co" in url:
        url = url.rstrip("/") + "?download=true"
    return download_url(url, output_path)


def download_pixeldrain(file_id_or_url: str, output_path: str) -> str:
    fid = file_id_or_url.rstrip("/").split("/")[-1]
    return download_url(f"https://pixeldrain.com/api/file/{fid}", output_path)
