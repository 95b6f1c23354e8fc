"""The dnnlib layer (counterpart of `stylemc_tpu/utils/dnnlib.py`):
EasyDict, a stdout/stderr tee, `open_url` with retries and an md5-keyed
cache (local paths and file:// URLs are opened directly), a checked file
download, and construction by dotted name.
"""

from __future__ import annotations

import glob
import hashlib
import importlib
import io
import os
import re
import sys
import uuid
from typing import Any, Optional

from ..io.pickle_loader import EasyDict  # noqa: F401  (re-export)


class Logger:
    """Tee stdout and stderr to a file."""

    def __init__(self, file_name: Optional[str] = None, file_mode: str = "w",
                 should_flush: bool = True):
        self.file = open(file_name, file_mode) if file_name else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        sys.stdout = self
        sys.stderr = self

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def write(self, text) -> None:
        if len(text) == 0:
            return
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self) -> None:
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self) -> None:
        self.flush()
        if sys.stdout is self:
            sys.stdout = self.stdout
        if sys.stderr is self:
            sys.stderr = self.stderr
        if self.file is not None:
            self.file.close()
            self.file = None


def is_url(obj: Any, allow_file_urls: bool = False) -> bool:
    if not isinstance(obj, str) or "://" not in obj:
        return False
    if allow_file_urls and obj.startswith("file://"):
        return True
    try:
        from urllib import parse
        res = parse.urlsplit(obj)
        return bool(res.scheme and res.netloc)
    except ValueError:
        return False


def open_url(url: str, cache_dir: Optional[str] = None, num_attempts: int = 10,
             verbose: bool = True, cache: bool = True):
    """Open a local path, a file:// URL or a URL as a binary stream. A URL's
    bytes are cached under `cache_dir` (default ~/.cache/stylemc_torch),
    keyed by the URL's md5, and read from there when present."""
    if url.startswith("file://"):
        from urllib import parse
        from urllib.request import url2pathname
        return open(url2pathname(parse.urlsplit(url).path), "rb")
    if not is_url(url):
        return open(url, "rb")
    assert num_attempts >= 1
    cache_dir = cache_dir or os.path.join(os.path.expanduser("~"),
                                          ".cache", "stylemc_torch")
    url_md5 = hashlib.md5(url.encode("utf-8")).hexdigest()
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        hits = glob.glob(os.path.join(cache_dir, url_md5 + "_*"))
        if hits:
            return open(hits[0], "rb")

    import requests

    url_name = None
    url_data = None
    with requests.Session() as session:
        if verbose:
            print(f"Downloading {url} ...", end="", flush=True)
        for attempts_left in reversed(range(num_attempts)):
            try:
                with session.get(url, timeout=(10, 60)) as res:
                    res.raise_for_status()
                    if len(res.content) == 0:
                        raise IOError("No data received")
                    # Google Drive's virus-check page links the real file
                    if len(res.content) < 8192:
                        content_str = res.content.decode("utf-8", "ignore")
                        if "download_warning" in res.headers.get(
                                "Set-Cookie", "") or \
                                "Google Drive" in content_str:
                            links = [link.replace("&amp;", "&")
                                     for link in re.findall(
                                         r'href="([^"]+)"', content_str)
                                     if "export=download" in link]
                            if len(links) == 1:
                                url = requests.compat.urljoin(url, links[0])
                                raise IOError("Google Drive virus checker nag")
                    match = re.search(
                        r'filename="([^"]*)"',
                        res.headers.get("Content-Disposition", ""))
                    url_name = match[1] if match else url
                    url_data = res.content
                    if verbose:
                        print(" done")
                    break
            except KeyboardInterrupt:
                raise
            except Exception:
                if not attempts_left:
                    if verbose:
                        print(" failed")
                    raise
                if verbose:
                    print(".", end="", flush=True)

    if cache:
        safe_name = re.sub(r"[^0-9a-zA-Z-._]", "_", url_name)
        cache_file = os.path.join(cache_dir, url_md5 + "_" + safe_name)
        temp_file = os.path.join(cache_dir,
                                 "tmp_" + uuid.uuid4().hex + "_" + safe_name)
        with open(temp_file, "wb") as f:
            f.write(url_data)
        os.replace(temp_file, cache_file)
    return io.BytesIO(url_data)


def download_file(session, file_spec: dict, chunk_size: int = 128,
                  num_attempts: int = 10) -> None:
    """Download with retries and checks: file_spec = {file_url, file_path,
    file_size?, file_md5?}."""
    file_path = file_spec["file_path"]
    file_url = file_spec["file_url"]
    file_dir = os.path.dirname(file_path)
    tmp_path = file_path + ".tmp." + uuid.uuid4().hex
    if file_dir:
        os.makedirs(file_dir, exist_ok=True)

    for attempts_left in reversed(range(num_attempts)):
        data_md5 = hashlib.md5()
        try:
            with session.get(file_url, stream=True, timeout=(10, 60)) as res:
                res.raise_for_status()
                with open(tmp_path, "wb") as f:
                    for chunk in res.iter_content(chunk_size=chunk_size << 10):
                        f.write(chunk)
                        data_md5.update(chunk)
            if "file_size" in file_spec:
                if os.stat(tmp_path).st_size != file_spec["file_size"]:
                    raise IOError("Incorrect file size", file_path)
            if "file_md5" in file_spec:
                if data_md5.hexdigest() != file_spec["file_md5"]:
                    raise IOError("Incorrect file MD5", file_path)
            break
        except Exception:
            if os.path.exists(tmp_path):
                os.remove(tmp_path)
            if not attempts_left:
                raise
    os.replace(tmp_path, file_path)


def get_obj_by_name(name: str) -> Any:
    """'module.sub.attr' → the object, importing the longest module prefix
    that resolves."""
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        try:
            module = importlib.import_module(".".join(parts[:i]))
            obj = module
            for attr in parts[i:]:
                obj = getattr(obj, attr)
            return obj
        except (ImportError, AttributeError):
            continue
    raise ImportError(name)


def call_func_by_name(*args, func_name: str, **kwargs) -> Any:
    return get_obj_by_name(func_name)(*args, **kwargs)


def construct_class_by_name(*args, class_name: str, **kwargs) -> Any:
    return get_obj_by_name(class_name)(*args, **kwargs)
