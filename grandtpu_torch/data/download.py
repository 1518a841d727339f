"""Dataset acquisition: resumable HTTP download with retries, the Google
Drive confirm-token flow, tar and zip extraction.

Port of ``grandtpu/data/download.py`` (reference ``scripts/download.py``:
resumable ``.part`` files and Range requests ``:20-95``, Drive confirm
tokens ``:105-125``, untar ``:133-142``, CLI ``:152-167``), on urllib alone.
Where the machine has no network, every function ends in a clear error.
``DATASET_URLS`` is grandtpu's registry of the datasets the repo does not
bundle; :func:`fetch_dataset` downloads and extracts one into the
directory that ``$GRANDTPU_DATA_DIR`` should then name::

    python -m grandtpu_torch.data.download --dataset reddit --path dataset
"""

from __future__ import annotations

import os
import sys
import tarfile
import time
import urllib.error
import urllib.parse
import urllib.request

CHUNK = 1 << 20


def _open(url: str, start: int = 0, timeout: float = 30.0):
    req = urllib.request.Request(url, headers={"User-Agent": "grandtpu"})
    if start > 0:
        req.add_header("Range", f"bytes={start}-")
    return urllib.request.urlopen(req, timeout=timeout)


def download(url: str, path: str, fname: str | None = None, *,
             max_retries: int = 5, backoff: float = 2.0,
             log=print) -> str:
    """Download ``url`` into the directory ``path``, resuming a partial
    ``.part`` file across retries and restarts (a Range request; a server
    that answers 200 instead of 206 restarts the file). An existing final
    file is kept. Returns the final file's path."""
    os.makedirs(path, exist_ok=True)
    if fname is None:
        fname = os.path.basename(urllib.parse.urlparse(url).path) or "file"
    final = os.path.join(path, fname)
    part = final + ".part"
    if os.path.exists(final):
        log(f"{final} already exists, skipping")
        return final

    attempt = 0
    while True:
        start = os.path.getsize(part) if os.path.exists(part) else 0
        try:
            with _open(url, start=start) as resp:
                resumed = resp.status == 206
                mode = "ab" if (start > 0 and resumed) else "wb"
                total = resp.headers.get("Content-Length")
                with open(part, mode) as f:
                    while chunk := resp.read(CHUNK):
                        f.write(chunk)
                if total is not None:
                    expected = int(total) + (start if resumed else 0)
                    if os.path.getsize(part) < expected:
                        raise IOError(f"short read: {os.path.getsize(part)}"
                                      f" < {expected}")
            os.replace(part, final)
            log(f"downloaded {final}")
            return final
        except OSError as e:        # urllib's URLError is an OSError
            attempt += 1
            if attempt > max_retries:
                raise IOError(f"download of {url} failed after "
                              f"{max_retries} retries: {e}") from e
            delay = backoff ** attempt
            log(f"retry {attempt}/{max_retries} after {delay:.0f}s: {e}")
            time.sleep(delay)


def download_from_google_drive(file_id: str, path: str, fname: str,
                               log=print) -> str:
    """Google Drive's large-file flow: the confirm token from the warning
    page's cookie, then the download with it (reference ``:105-125``)."""
    base = "https://docs.google.com/uc?export=download"
    url = f"{base}&id={file_id}"
    try:
        with _open(url) as resp:
            cookies = resp.headers.get_all("Set-Cookie") or []
    except urllib.error.URLError as e:
        raise IOError(f"google drive probe failed: {e}") from e
    token = next((c.split("=", 1)[1].split(";", 1)[0] for c in cookies
                  if "download_warning" in c), None)
    if token:
        url = f"{base}&confirm={token}&id={file_id}"
    return download(url, path, fname, log=log)


def _check_members(names, dest: str, kind: str) -> None:
    """Refuse an archive member that would land outside ``dest``."""
    base = os.path.realpath(dest)
    for name in names:
        target = os.path.realpath(os.path.join(dest, name))
        if not target.startswith(base + os.sep) and target != base:
            raise ValueError(f"unsafe {kind} member path: {name}")


def untar(tar_path: str, dest: str | None = None, log=print) -> str:
    """Extract a tar(.gz) archive next to itself (reference ``:133-142``),
    refusing members that would escape the destination directory."""
    dest = dest or os.path.dirname(tar_path) or "."
    with tarfile.open(tar_path) as tf:
        _check_members(tf.getnames(), dest, "tar")
        tf.extractall(dest, filter="data")
    log(f"extracted {tar_path} -> {dest}")
    return dest


def unzip(zip_path: str, dest: str | None = None, log=print) -> str:
    """Extract a zip archive next to itself, refusing members that would
    escape the destination directory (the large datasets ship as zips,
    reference ``README.md:25-28``)."""
    import zipfile

    dest = dest or os.path.dirname(zip_path) or "."
    with zipfile.ZipFile(zip_path) as zf:
        _check_members(zf.namelist(), dest, "zip")
        zf.extractall(dest)
    log(f"extracted {zip_path} -> {dest}")
    return dest


def extract(archive_path: str, dest: str | None = None, log=print) -> str:
    """Extract a zip or a tar; any other file stays where it is. Returns
    the directory."""
    if archive_path.endswith(".zip"):
        return unzip(archive_path, dest, log=log)
    if tarfile.is_tarfile(archive_path):
        return untar(archive_path, dest, log=log)
    return os.path.dirname(archive_path) or "."


# the datasets the repo does not bundle, as the reference documents them
# (``README.md:25-28``, Tsinghua Cloud mirrors): name -> (url, filename)
DATASET_URLS = {
    "aminer": ("https://cloud.tsinghua.edu.cn/f/"
               "629a605e453b40fc9a93/?dl=1", "aminer.zip"),
    "reddit": ("https://cloud.tsinghua.edu.cn/f/"
               "384be92876ed4127aa3c/?dl=1", "reddit.zip"),
    "Amazon2M": ("https://cloud.tsinghua.edu.cn/f/"
                 "7c867cef16214fe1a30b/?dl=1", "Amazon2M.zip"),
    "mag_scholar_c": ("https://cloud.tsinghua.edu.cn/f/"
                      "5e5c9d8833a143d5abb4/?dl=1", "mag_scholar_c.npz"),
}


def fetch_dataset(name: str, path: str = "dataset", log=print) -> str:
    """Download (resumable) and extract a dataset of ``DATASET_URLS`` into
    ``path``. Returns the dataset directory."""
    if name not in DATASET_URLS:
        raise KeyError(f"no registered URL for dataset {name!r}; known: "
                       f"{sorted(DATASET_URLS)}")
    url, fname = DATASET_URLS[name]
    return extract(download(url, path, fname, log=log), log=log)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="grandtpu_torch-download")
    p.add_argument("--url", help="http(s) URL to fetch")
    p.add_argument("--gdrive-id", help="Google Drive file id")
    p.add_argument("--dataset", help="registered dataset name "
                   f"({', '.join(sorted(DATASET_URLS))})")
    p.add_argument("--path", default="dataset", help="output directory")
    p.add_argument("--fname", default=None, help="output filename")
    p.add_argument("--untar", action="store_true",
                   help="extract after download")
    args = p.parse_args(argv)
    if not args.url and not args.gdrive_id and not args.dataset:
        p.error("one of --url / --gdrive-id / --dataset is required")
    try:
        if args.dataset:
            fetch_dataset(args.dataset, args.path)
            return 0
        if args.gdrive_id:
            out = download_from_google_drive(
                args.gdrive_id, args.path, args.fname or args.gdrive_id)
        else:
            out = download(args.url, args.path, args.fname)
        if args.untar:
            extract(out)
    except (OSError, ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
