"""The port's downloader (``grandtpu_torch.data.download``), in the cases of
``tests/test_download.py``, against a local HTTP server on 127.0.0.1 (no
other host is contacted): a full download, a resume from a partial file by
a Range request, retries then success, giving up, an existing file kept,
tar and zip extraction with their escape checks, the dataset registry;
and its CLI, and the registry error that names it."""

import http.server
import io
import os
import subprocess
import sys
import tarfile
import threading
import zipfile

import pytest

from grandtpu_torch.data import download as dl
from grandtpu_torch.data import load_data
from grandtpu_torch.data.download import download, untar, unzip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAYLOAD = os.urandom(3 * (1 << 16))


class RangeHandler(http.server.BaseHTTPRequestHandler):
    fail_first = {"count": 0}
    files: dict = {}   # path -> bytes served there (default: PAYLOAD)
    ranges: list = []  # the Range header of every request, or None

    def do_GET(self):
        if self.path == "/flaky" and RangeHandler.fail_first["count"] > 0:
            RangeHandler.fail_first["count"] -= 1
            self.send_response(500)
            self.end_headers()
            return
        data = RangeHandler.files.get(self.path, PAYLOAD)
        rng = self.headers.get("Range")
        RangeHandler.ranges.append(rng)
        if rng:
            start = int(rng.split("=")[1].rstrip("-").split("-")[0])
            body = data[start:]
            self.send_response(206)
            self.send_header("Content-Range",
                             f"bytes {start}-{len(data) - 1}/{len(data)}")
        else:
            body = data
            self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def server():
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), RangeHandler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def quiet(*_):
    pass


def test_full_download(server, tmp_path):
    out = download(f"{server}/file.bin", str(tmp_path), log=quiet)
    assert open(out, "rb").read() == PAYLOAD
    assert not (tmp_path / "file.bin.part").exists()


def test_resume_from_partial(server, tmp_path):
    (tmp_path / "file.bin.part").write_bytes(PAYLOAD[:1000])
    RangeHandler.ranges.clear()
    out = download(f"{server}/file.bin", str(tmp_path), log=quiet)
    assert open(out, "rb").read() == PAYLOAD
    assert RangeHandler.ranges == ["bytes=1000-"]


def test_retry_then_succeed(server, tmp_path):
    RangeHandler.fail_first["count"] = 2
    logs = []
    out = download(f"{server}/flaky", str(tmp_path), fname="flaky.bin",
                   backoff=1.0, log=logs.append)
    assert open(out, "rb").read() == PAYLOAD
    assert sum(m.startswith("retry") for m in logs) == 2


def test_gives_up_after_retries(server, tmp_path):
    RangeHandler.fail_first["count"] = 99
    try:
        with pytest.raises(IOError, match="after 2 retries"):
            download(f"{server}/flaky", str(tmp_path), fname="dead.bin",
                     max_retries=2, backoff=1.0, log=quiet)
    finally:
        RangeHandler.fail_first["count"] = 0


def test_existing_file_skipped(server, tmp_path):
    (tmp_path / "file.bin").write_bytes(b"old")
    out = download(f"{server}/file.bin", str(tmp_path), log=quiet)
    assert open(out, "rb").read() == b"old"  # untouched


def test_untar_roundtrip(tmp_path):
    src = tmp_path / "payload.txt"
    src.write_text("hello grand")
    tar_p = tmp_path / "a.tar.gz"
    with tarfile.open(tar_p, "w:gz") as tf:
        tf.add(src, arcname="inner/payload.txt")
    assert untar(str(tar_p), log=quiet) == str(tmp_path)
    assert (tmp_path / "inner" / "payload.txt").read_text() == "hello grand"


def test_untar_rejects_escape(tmp_path):
    tar_p = tmp_path / "evil.tar"
    data = b"pwn"
    with tarfile.open(tar_p, "w") as tf:
        info = tarfile.TarInfo("../../escape.txt")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
    with pytest.raises(ValueError, match="unsafe"):
        untar(str(tar_p), log=quiet)
    assert not (tmp_path.parent.parent / "escape.txt").exists()


def test_unzip_roundtrip_and_escape(tmp_path):
    zp = tmp_path / "a.zip"
    with zipfile.ZipFile(zp, "w") as zf:
        zf.writestr("inner/payload.txt", "hello zip")
    unzip(str(zp), log=quiet)
    assert (tmp_path / "inner" / "payload.txt").read_text() == "hello zip"
    evil = tmp_path / "evil.zip"
    with zipfile.ZipFile(evil, "w") as zf:
        zf.writestr("../../escape.txt", "pwn")
    with pytest.raises(ValueError, match="unsafe"):
        unzip(str(evil), log=quiet)


def _serve_zip(server, monkeypatch) -> None:
    """Register ``aminer`` at a zip the test server hands out."""
    payload = io.BytesIO()
    with zipfile.ZipFile(payload, "w") as zf:
        zf.writestr("aminer/adj.pkl", b"\x00fake")
    RangeHandler.files["/aminer.zip"] = payload.getvalue()
    monkeypatch.setitem(dl.DATASET_URLS, "aminer",
                        (f"{server}/aminer.zip", "aminer.zip"))


def test_fetch_dataset_registry(server, tmp_path, monkeypatch):
    """fetch_dataset: registered URL -> resumable download -> extract;
    the registry is grandtpu's."""
    from grandtpu.data.download import DATASET_URLS as jax_urls

    assert {k: v for k, v in dl.DATASET_URLS.items()} == jax_urls
    _serve_zip(server, monkeypatch)
    out_dir = dl.fetch_dataset("aminer", str(tmp_path), log=quiet)
    assert (tmp_path / "aminer" / "adj.pkl").read_bytes() == b"\x00fake"
    assert out_dir == str(tmp_path)
    with pytest.raises(KeyError, match="no registered URL"):
        dl.fetch_dataset("nope", str(tmp_path))


def test_cli_fetches_and_reports_errors(server, tmp_path, monkeypatch,
                                        capsys):
    """``python -m grandtpu_torch.data.download``: ``--url`` with
    ``--untar``, ``--dataset``, and rc 2 with the error on stderr."""
    _serve_zip(server, monkeypatch)
    assert dl.main(["--url", f"{server}/aminer.zip", "--path",
                    str(tmp_path / "u"), "--untar"]) == 0
    assert (tmp_path / "u" / "aminer" / "adj.pkl").exists()
    assert dl.main(["--dataset", "aminer", "--path",
                    str(tmp_path / "d")]) == 0
    assert (tmp_path / "d" / "aminer" / "adj.pkl").exists()
    capsys.readouterr()
    assert dl.main(["--dataset", "nope", "--path", str(tmp_path)]) == 2
    assert "no registered URL" in capsys.readouterr().err
    out = subprocess.run(
        [sys.executable, "-m", "grandtpu_torch.data.download"], cwd=REPO,
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 2 and "--dataset" in out.stderr


def test_missing_dataset_names_the_downloader(tmp_path, monkeypatch):
    monkeypatch.setenv("GRANDTPU_DATA_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError,
                       match=r"grandtpu_torch\.data\.download"):
        load_data("reddit")
