"""The port's object-store data plane against the JAX package's, at
tolerance 0: SigV4 signatures at a fixed clock (AWS's published vectors
and arbitrary requests), scheme detection and the ``s3://`` mapping,
ranged and chunked reads through the port's ``range_server``, missing
and denied objects, the retry budget, and the BGZF reader and tabix
index over ``http://``.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from sbeacon_tpu.genomics import bgzf as jb
from sbeacon_tpu.genomics import tabix as jt
from sbeacon_tpu.io import sigv4 as js
from sbeacon_tpu.io import sources as jsrc
from sbeacon_tpu.testing import range_server as j_range_server
from sbeacon_tpu_torch.genomics import bgzf as tb
from sbeacon_tpu_torch.genomics import tabix as tt
from sbeacon_tpu_torch.io import sigv4 as ts
from sbeacon_tpu_torch.io import sources as tsrc
from sbeacon_tpu_torch.testing import make_test_vcf, range_server
from torch_ingest_corpus import no_thread_leak  # noqa: F401

SECRET = "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY"


@pytest.mark.parametrize("date,region,service", [
    ("20120215", "us-east-1", "iam"), ("20150830", "us-east-1", "iam"),
    ("20240101", "eu-west-1", "s3"),
])
def test_signing_key_equal(date, region, service):
    k = ts.derive_signing_key(SECRET, date, region, service)
    assert k == js.derive_signing_key(SECRET, date, region, service)
    if date == "20120215":  # AWS's published example
        assert k.hex() == ("f4780e2d9f65fa895f9c67b32ce1baf0b0d8a43505a000"
                           "a1a9e090d414db404d")


@pytest.mark.parametrize("method,url,headers,token", [
    ("GET", "https://example.amazonaws.com/", {}, None),
    ("GET", "https://h/o?b=2&a=1", {"X-Custom": "a  b"}, None),
    ("GET", "https://h/b/k%20ey#x?y", {"Range": "bytes=0-9"}, "tok"),
    ("HEAD", "https://s3.eu-west-1.amazonaws.com/bk/a/b.vcf.gz", {}, None),
    ("GET", "http://127.0.0.1:9/bk/o?list-type=2&prefix=a%2Fb", {}, "s"),
])
def test_sigv4_signatures_equal_at_a_fixed_clock(method, url, headers,
                                                 token):
    now = time.strptime("20150830T123600Z", "%Y%m%dT%H%M%SZ")
    kw = dict(region="us-east-1", service="service", session_token=token)
    a = ts.SigV4Signer("AKIDEXAMPLE", SECRET, **kw).sign(
        method, url, dict(headers), now=now)
    b = js.SigV4Signer("AKIDEXAMPLE", SECRET, **kw).sign(
        method, url, dict(headers), now=now)
    assert a == b
    if url == "https://example.amazonaws.com/":
        # AWS SigV4 test suite, get-vanilla (hashed empty payload)
        c = ts.SigV4Signer("AKIDEXAMPLE", SECRET, region="us-east-1",
                           service="service").sign(
            method, url, {}, payload_hash=(
                "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca4"
                "95991b7852b855"), now=now)
        assert c["Authorization"].endswith(
            "Signature=5fa00fa31553b73ebf1942676e86291e8372ff2a2260956d9b8"
            "aae1d763fbf31")


def test_signer_from_env_equal():
    env = {"BEACON_S3_ACCESS_KEY": "AK", "BEACON_S3_SECRET_KEY": "SK",
           "BEACON_S3_REGION": "ap-south-1",
           "BEACON_S3_SESSION_TOKEN": "T"}
    a, b = ts.signer_from_env(env), js.signer_from_env(env)
    now = time.gmtime(1_700_000_000)
    assert a.sign("GET", "https://h/x", {}, now=now) == b.sign(
        "GET", "https://h/x", {}, now=now)
    assert ts.signer_from_env({}) is None and js.signer_from_env({}) is None


@pytest.mark.parametrize("loc", ["http://x/y", "https://x", "s3://b/k",
                                 "/tmp/a.vcf.gz", "file.vcf", "gs://b/k"])
def test_scheme_detection(loc):
    assert tsrc.is_remote(loc) == jsrc.is_remote(loc)


@pytest.mark.parametrize("env", [
    {"BEACON_S3_ENDPOINT": "http://127.0.0.1:9/"},
    {"BEACON_S3_ENDPOINT": "http://e", "BEACON_S3_TOKEN": "Bearer t"},
    {"BEACON_S3_ACCESS_KEY": "AK", "BEACON_S3_SECRET_KEY": "SK",
     "BEACON_S3_REGION": "eu-west-2"},
])
def test_resolve_s3_equal(monkeypatch, env):
    for k in ("BEACON_S3_ENDPOINT", "BEACON_S3_TOKEN", "BEACON_S3_ACCESS_KEY",
              "BEACON_S3_SECRET_KEY", "BEACON_S3_REGION"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for key in ("bk/a/b c.vcf.gz", "bk/k#1?x", "bk/"):
        ut, ht, st = tsrc.resolve_s3(f"s3://{key}")
        uj, hj, sj = jsrc.resolve_s3(f"s3://{key}")
        assert (ut, ht, st is None) == (uj, hj, sj is None)


def test_resolve_s3_without_endpoint_raises(monkeypatch):
    for k in ("BEACON_S3_ENDPOINT", "BEACON_S3_ACCESS_KEY",
              "BEACON_S3_SECRET_KEY"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(tsrc.RemoteIOError, match="BEACON_S3_ENDPOINT"):
        tsrc.open_source("s3://b/k").size()


@pytest.fixture
def served(tmp_path):
    p = tmp_path / "r.vcf.gz"
    make_test_vcf(p, seed=8, chroms=("1", "2"), n_per_chrom=1500,
                  n_samples=3)
    tt.ensure_index(p)
    with range_server(tmp_path) as base:
        yield base, tmp_path, p.name


@pytest.mark.parametrize("workers", [1, 4])
def test_ranged_reads_equal(served, workers):
    base, root, name = served
    data = (root / name).read_bytes()
    st = tsrc.open_source(f"{base}/{name}")
    sj = jsrc.HttpRangeSource(f"{base}/{name}", chunk_bytes=4096)
    st_small = tsrc.HttpRangeSource(f"{base}/{name}", chunk_bytes=4096)
    assert isinstance(st, tsrc.HttpRangeSource)
    assert st.exists() and sj.exists()
    assert st.size() == sj.size() == len(data)
    rng = random.Random(workers)
    for _ in range(8):
        a = rng.randrange(len(data))
        b = min(len(data) + 100, a + rng.randrange(1, 30_000))
        got = st_small.read_range(a, b, workers=workers)
        assert got == sj.read_range(a, b, workers=workers) == data[a:b]
    assert tsrc.read_bytes(f"{base}/{name}") == data
    assert tsrc.read_bytes(root / name) == jsrc.read_bytes(root / name)
    local = tsrc.open_source(root / name)
    assert isinstance(local, tsrc.LocalFileSource)
    assert local.read_range(10, 99) == data[10:99]


def test_missing_and_denied_equal(tmp_path):
    (tmp_path / "obj").write_bytes(b"x" * 10)
    with range_server(tmp_path, require_token="Bearer s") as base:
        for mod in (tsrc, jsrc):
            with pytest.raises(mod.RemoteIOError) as ei:
                mod.open_source(f"{base}/obj").exists()
            assert ei.value.status == 403
        ok = tsrc.HttpRangeSource(f"{base}/obj",
                                  headers={"Authorization": "Bearer s"})
        assert ok.read_range(0, 10) == b"x" * 10
    with j_range_server(tmp_path) as base:  # the JAX server, the port reads
        assert tsrc.open_source(f"{base}/obj").exists()
        assert not tsrc.open_source(f"{base}/nope").exists()
        assert not jsrc.open_source(f"{base}/nope").exists()


def test_transient_errors_retried_then_raised(tmp_path):
    payload = b"y" * 5000
    fail = {"n": 1}

    class Flaky(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if fail["n"] > 0:
                fail["n"] -= 1
                self.send_response(500)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            rng = self.headers.get("Range")
            if rng and rng.startswith("bytes="):
                a, _, b = rng[6:].partition("-")
                start, end = int(a), int(b) + 1 if b else len(payload)
                body = payload[start:end]
                self.send_response(206)
                self.send_header("Content-Range",
                                 f"bytes {start}-{end - 1}/{len(payload)}")
            else:
                body = payload
                self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Flaky)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/x"
        assert tsrc.HttpRangeSource(url, retries=2).size() == len(payload)
        fail["n"] = 1
        assert tsrc.HttpRangeSource(url, retries=2).read_range(
            100, 200) == payload[100:200]
        fail["n"] = 10
        with pytest.raises(tsrc.RemoteIOError) as ei:
            tsrc.HttpRangeSource(url, retries=1).size()
        assert ei.value.status is None
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(30)


def test_remote_bgzf_and_tabix_equal(served):
    base, root, name = served
    url = f"{base}/{name}"
    rt, rj = tb.BgzfReader(url), jb.BgzfReader(root / name)
    lines = list(rj.iter_lines())
    assert list(rt.iter_lines()) == lines
    va, vb = lines[100][0], lines[2000][0]
    assert rt.read_range(va, vb) == rj.read_range(va, vb)
    assert dataclasses.asdict(tt.find_index_for(url)) == dataclasses.asdict(
        jt.find_index_for(root / name))
    assert tt.list_chromosomes(url) == ["1", "2"]
    from sbeacon_tpu.genomics.vcf import iter_vcf_records as j_iter
    from sbeacon_tpu_torch.genomics.vcf import iter_vcf_records as t_iter

    got = [dataclasses.asdict(r) for r in t_iter(url, region=("2", 1, 20_000))]
    assert got == [dataclasses.asdict(r)
                   for r in j_iter(root / name, region=("2", 1, 20_000))]
    assert got


def test_s3_mapping_serves_and_token_gate(tmp_path, monkeypatch):
    (tmp_path / "bk").mkdir()
    (tmp_path / "bk" / "o.bin").write_bytes(b"z" * 3000)
    for k in ("BEACON_S3_ACCESS_KEY", "BEACON_S3_SECRET_KEY"):
        monkeypatch.delenv(k, raising=False)
    with range_server(tmp_path, require_token="Bearer k") as base:
        monkeypatch.setenv("BEACON_S3_ENDPOINT", base)
        monkeypatch.setenv("BEACON_S3_TOKEN", "Bearer k")
        src = tsrc.open_source("s3://bk/o.bin")
        assert src.size() == 3000
        assert src.read_range(5, 50, workers=2) == b"z" * 45
        monkeypatch.setenv("BEACON_S3_TOKEN", "Bearer wrong")
        with pytest.raises(tsrc.RemoteIOError):
            tsrc.open_source("s3://bk/o.bin").size()
