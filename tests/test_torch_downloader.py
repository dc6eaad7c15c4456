"""The port's download transports (`video_styler_tpu_torch/utils/
downloader.py`) and `ModelConfig`'s fetch, as `tests/test_downloader.py`
holds the JAX package's: against an `http.server` bound to 127.0.0.1 that
serves the ModelScope and Hugging Face repository APIs from files under
`tmp_path`. Nothing leaves the loopback interface: the endpoints are set
to the local server, and the suite's VIDEO_STYLER_OFFLINE=1 is lifted only
inside the `http_repo` fixture."""
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, unquote, urlparse

import pytest

from video_styler_tpu.utils import downloader as JD
from video_styler_tpu_torch.utils import downloader as D
from video_styler_tpu_torch.utils import model_config as MC
from video_styler_tpu_torch.utils.model_config import ModelConfig

from test_torch_pipeline import cpu_share  # noqa: F401

REPO_FILES = {
    "diffusion_pytorch_model.safetensors": b"\x00" * 64,
    "models_t5_umt5-xxl-enc-bf16.pth": b"\x01" * 32,
    "google/umt5-xxl/spiece.model": b"SPIECE",
    "google/umt5-xxl/tokenizer_config.json": b"{}",
}


def _handler(root):
    """A request handler serving the files under `root` through both APIs."""

    class Handler(BaseHTTPRequestHandler):
        calls = []

        def log_message(self, *a):
            pass

        def _send(self, body, code=200):
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _file(self, rel):
            path = os.path.join(root, rel)
            if rel not in REPO_FILES or not os.path.isfile(path):
                return self._send(b"not found", 404)
            with open(path, "rb") as f:
                return self._send(f.read())

        def do_GET(self):  # noqa: N802
            Handler.calls.append(self.path)
            u = urlparse(self.path)
            if u.path.endswith("/repo/files"):
                files = [{"Path": p, "Type": "blob"} for p in REPO_FILES]
                return self._send(json.dumps({"Data": {"Files": files}}).encode())
            if u.path.endswith("/repo"):
                return self._file(unquote(parse_qs(u.query).get("FilePath", [""])[0]))
            if u.path.startswith("/api/models/"):
                return self._send(json.dumps(
                    {"siblings": [{"rfilename": p} for p in REPO_FILES]}).encode())
            if "/resolve/main/" in u.path:
                return self._file(unquote(u.path.split("/resolve/main/", 1)[1]))
            return self._send(b"bad request", 400)
    return Handler


@pytest.fixture()
def http_repo(tmp_path, monkeypatch):
    root = tmp_path / "served"
    for rel, body in REPO_FILES.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(body)
    handler = _handler(str(root))
    server = HTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    ep = f"http://127.0.0.1:{server.server_port}"
    monkeypatch.setenv("VIDEO_STYLER_OFFLINE", "0")
    monkeypatch.setenv("VIDEO_STYLER_MODELSCOPE_ENDPOINT", ep)
    monkeypatch.setenv("VIDEO_STYLER_HF_ENDPOINT", ep)
    monkeypatch.setenv("VIDEO_STYLER_MODEL_DIR", str(tmp_path / "models"))
    yield handler
    server.shutdown()
    server.server_close()


@pytest.mark.parametrize("mod", [D, JD], ids=["port", "jax"])
def test_modelscope_transport_glob(http_repo, tmp_path, mod):
    got = mod.modelscope_transport("Wan-AI/Wan2.1-VACE-14B", str(tmp_path / "d"),
                                   "*.safetensors")
    assert len(got) == 1 and got[0].endswith(".safetensors")
    with open(got[0], "rb") as f:
        assert f.read() == REPO_FILES["diffusion_pytorch_model.safetensors"]


def test_modelscope_transport_folder_matches_jax(http_repo, tmp_path):
    got = D.modelscope_transport("x/y", str(tmp_path / "d"), "google/umt5-xxl/")
    want = JD.modelscope_transport("x/y", str(tmp_path / "j"), "google/umt5-xxl/")
    assert sorted(os.path.basename(p) for p in got) == ["spiece.model",
                                                       "tokenizer_config.json"]
    assert [os.path.relpath(p, tmp_path / "d") for p in got] == \
        [os.path.relpath(p, tmp_path / "j") for p in want]


def test_huggingface_transport(http_repo, tmp_path):
    got = D.huggingface_transport("x/y", str(tmp_path / "d"), "*.pth")
    assert len(got) == 1
    with open(got[0], "rb") as f:
        assert f.read() == REPO_FILES["models_t5_umt5-xxl-enc-bf16.pth"]
    with pytest.raises(FileNotFoundError, match="no files matching"):
        D.huggingface_transport("x/y", str(tmp_path / "d"), "*.bin")


def test_model_config_downloads_once_then_reads_the_cache(http_repo):
    """A `ModelConfig` with a model id only: the stock transport registers
    itself on first need, rank 0 (the only process here) downloads, and the
    second resolve reads the cache with no request."""
    MC._TRANSPORTS.pop("ModelScope", None)
    D._REGISTERED = False
    cfg = ModelConfig(model_id="Wan-AI/Wan2.1-VACE-14B", origin_file_pattern="*.safetensors")
    assert cfg.paths()[0].endswith("diffusion_pytorch_model.safetensors")
    assert os.path.isfile(cfg.path)
    n = len(http_repo.calls)
    again = ModelConfig(model_id="Wan-AI/Wan2.1-VACE-14B", origin_file_pattern="*.safetensors")
    again.resolve()
    assert again.path == cfg.path and len(http_repo.calls) == n


def test_register_transport_and_skip_download(http_repo, tmp_path):
    seen = []

    def fake(model_id, local_dir, allow):
        seen.append((model_id, allow))
        os.makedirs(local_dir, exist_ok=True)
        open(os.path.join(local_dir, "w.safetensors"), "wb").close()
    MC.register_transport("Fake", fake)
    cfg = ModelConfig(model_id="a/b", origin_file_pattern="*.safetensors",
                      download_resource="Fake")
    assert os.path.basename(cfg.paths()[0]) == "w.safetensors"
    assert seen == [("a/b", "*.safetensors")]
    with pytest.raises(FileNotFoundError, match="model_id='c/d'"):
        ModelConfig(model_id="c/d", origin_file_pattern="*.pth", download_resource="Fake",
                    skip_download=True).paths()
    assert len(seen) == 1
    MC._TRANSPORTS.pop("Fake")


def test_download_tokenizer_and_fetch_near_fallthrough(http_repo, tmp_path, monkeypatch):
    """`download_tokenizer` fetches the files into a directory; the
    prompter's `fetch_tokenizer_near` falls through to it when nothing lies
    beside the checkpoints (and not with VIDEO_STYLER_OFFLINE=1)."""
    d = D.download_tokenizer("google/umt5-xxl", local_dir=str(tmp_path / "tok"),
                             files=["google/umt5-xxl/spiece.model",
                                    "google/umt5-xxl/tokenizer_config.json"])
    assert os.path.isfile(os.path.join(d, "google/umt5-xxl/spiece.model"))
    from video_styler_tpu_torch.prompters.wan_prompter import WanPrompter
    fetched = {}
    p = WanPrompter()
    monkeypatch.setattr(p, "fetch_tokenizer", lambda path: fetched.setdefault("path", path))
    monkeypatch.setattr(D, "download_tokenizer", lambda *a, **k: str(tmp_path / "tok"))
    ck = tmp_path / "nothing" / "model.safetensors"
    assert p.fetch_tokenizer_near([str(ck)]) is True
    assert fetched["path"] == str(tmp_path / "tok")
    monkeypatch.setenv("VIDEO_STYLER_OFFLINE", "1")
    assert WanPrompter().fetch_tokenizer_near([str(ck)]) is False


def test_offline_gate(http_repo, monkeypatch, tmp_path):
    monkeypatch.setenv("VIDEO_STYLER_OFFLINE", "1")
    with pytest.raises(RuntimeError, match="OFFLINE"):
        D.modelscope_transport("x/y", str(tmp_path), "*")
    with pytest.raises(FileNotFoundError, match="VIDEO_STYLER_OFFLINE=1"):
        ModelConfig(model_id="x/y", origin_file_pattern="*.pth").paths()
    assert http_repo.calls == []


def test_retry_then_success(http_repo, monkeypatch):
    import urllib.error
    import urllib.request
    attempts = {"n": 0}
    real_urlopen = urllib.request.urlopen

    def flaky(req, **kw):
        attempts["n"] += 1
        if attempts["n"] == 1:
            raise urllib.error.URLError("boom")
        return real_urlopen(req, **kw)

    monkeypatch.setattr(urllib.request, "urlopen", flaky)
    monkeypatch.setattr(D.time, "sleep", lambda s: None)
    assert D.modelscope_list_files("x/y") and attempts["n"] == 2


def test_failed_download_raises_after_retries(http_repo, monkeypatch, tmp_path):
    monkeypatch.setattr(D.time, "sleep", lambda s: None)
    with pytest.raises(RuntimeError, match="after 3 attempts"):
        D._http_get(os.environ["VIDEO_STYLER_HF_ENDPOINT"] + "/missing", retries=3)
