"""The port's index I/O, shard loading and server entry.

``load_index`` of a shard the JAX package saved (compressed with
genotype planes, uncompressed without) equals
``shard_from_reference(sbeacon_tpu.index.columnar.load_index(path))``
array for array and in its meta; a shard the port saves loads back the
same in both packages. ``IngestService.load_all`` over a data root the
JAX ``/submit`` wrote skips interrupted saves (``*.tmp.npz``) and the
``portable/`` export, as the JAX service does. Then
``python -m sbeacon_tpu_torch.api.server --device cpu --data-root DIR``
runs as a child process over a copy of that root: ``/health``,
``/ready`` and one ``/g_variants`` answer, the last equal to the JAX
app's (masked as in tests/torch_app_corpus.py), and SIGINT stops it.
``--worker`` is refused.
"""

import json
import os
import random
import signal
import socket
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.genomics.tabix import ensure_index
from sbeacon_tpu.genomics.vcf import write_vcf
from sbeacon_tpu.index import build_index as j_build_index
from sbeacon_tpu.index.columnar import load_index as j_load_index
from sbeacon_tpu.index.columnar import save_index as j_save_index
from sbeacon_tpu.testing import random_records
from sbeacon_tpu_torch.api import server as pserver
from sbeacon_tpu_torch.config import BeaconConfig
from sbeacon_tpu_torch.index import load_index, save_index
from sbeacon_tpu_torch.index import shard_from_reference
from torch_app_corpus import (
    SAMPLES,
    SEX_TERMS,
    close_jax,
    close_port,
    copy_root,
    dumped,
    jax_ingest,
    open_jax,
    open_port,
    submission,
)

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("chrom_offsets", "ref_blob", "ref_off", "alt_blob", "alt_off",
          "vt_codes", "gt_bits", "gt_bits2", "tok_bits1", "tok_bits2",
          "gt_overflow", "tok_overflow")


def assert_same_shard(got, want):
    assert got.meta == want.meta
    assert sorted(got.cols) == sorted(want.cols)
    for k in want.cols:
        assert got.cols[k].dtype == want.cols[k].dtype, k
        assert np.array_equal(got.cols[k], want.cols[k]), k
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if b is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert np.array_equal(a, b), f


def _jax_shard(seed, samples):
    recs = random_records(random.Random(seed), chrom="22", n=150,
                          n_samples=len(samples), p_multiallelic=0.3)
    return j_build_index(recs, dataset_id=f"d{seed}",
                         vcf_location=f"v{seed}.vcf.gz",
                         sample_names=samples)


@pytest.mark.parametrize("compress,samples", [
    (True, [f"S{i}" for i in range(40)]),
    (False, []),
])
def test_load_index_equals_jax(tmp_path, compress, samples):
    jshard = _jax_shard(3, samples)
    assert (jshard.gt_bits is not None) == bool(samples)
    path = tmp_path / "ds" / "shard.npz"
    j_save_index(jshard, path, compress=compress)
    want = shard_from_reference(j_load_index(path))
    assert_same_shard(load_index(path), want)
    # and the other way: what the port saves, both packages load the same
    back = tmp_path / "ds" / "port.npz"
    save_index(load_index(path), back, compress=compress)
    assert_same_shard(load_index(back), want)
    assert_same_shard(shard_from_reference(j_load_index(back)), want)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("srv")
    subs = []
    for d in range(2):
        recs = random_records(random.Random(40 + d), chrom="22", n=100,
                              n_samples=len(SAMPLES), p_no_acan=0.3)
        vcf = root / f"ds{d}.vcf.gz"
        write_vcf(vcf, recs, sample_names=SAMPLES)
        ensure_index(vcf)
        subs.append(submission(f"ds{d}", f"c{d}", vcf,
                               lambda i: SEX_TERMS[i % 2]))
    jax_ingest(root / "data", subs)
    return root / "data"


def test_load_all_skips_tmp_and_portable(data_root, tmp_path):
    port_root = copy_root(data_root, tmp_path / "port")
    index_dir = port_root / "variant-index"
    assert list(index_dir.glob("portable/*/*"))
    (index_dir / "ds0" / "crashed.npz.tmp.npz").write_bytes(b"partial")
    japp = open_jax(port_root)
    papp = open_port(port_root)
    try:
        assert len(papp.engine._indexes) == len(japp.engine._indexes) == 2
        assert papp.ingest.load_all() == japp.ingest.load_all() == 2
    finally:
        close_port(papp)
        close_jax(japp)


def test_from_env_matches_jax(monkeypatch, tmp_path):
    for var, val in (("BEACON_ID", "b.x"), ("BEACON_MAX_IN_FLIGHT", "7"),
                     ("BEACON_DEADLINE_S", "12.5"),
                     ("BEACON_RUNNER_WORKERS", "3"),
                     ("BEACON_RESPONSE_CACHE", "off"),
                     ("BEACON_WINDOW_CAP", "512"),
                     ("BEACON_SUBMIT_TOKEN", "tok")):
        monkeypatch.setenv(var, val)
    want = JBeaconConfig.from_env(tmp_path)
    got = BeaconConfig.from_env(tmp_path)
    assert got.storage.root == want.storage.root
    assert got.storage.index_dir == want.storage.index_dir
    assert got.info == type(got.info)(**{
        f: getattr(want.info, f) for f in got.info.__dataclass_fields__})
    for section in ("resilience", "engine", "auth"):
        mine = getattr(got, section)
        theirs = getattr(want, section)
        for f in mine.__dataclass_fields__:
            assert getattr(mine, f) == getattr(theirs, f), (section, f)


def test_worker_refused(capsys):
    with pytest.raises(SystemExit) as e:
        pserver.main(["--worker", "http://127.0.0.1:1", "--device", "cpu"])
    assert e.value.code == 2
    assert "fleet plane" in capsys.readouterr().err


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_entry_serves_a_data_root(data_root, tmp_path):
    port_root = copy_root(data_root, tmp_path / "port")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1")
    errors = open(tmp_path / "stderr.txt", "w")
    child = subprocess.Popen(
        [sys.executable, "-m", "sbeacon_tpu_torch.api.server",
         "--device", "cpu", "--data-root", str(port_root),
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=errors,
        text=True,
    )
    japp = open_jax(data_root)
    try:
        line = child.stdout.readline()
        assert line.startswith(f"beacon serving on 127.0.0.1:{port}"), (
            line, (tmp_path / "stderr.txt").read_text())
        assert "(2 index shards loaded, device cpu" in line
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{base}/health", timeout=30) as r:
            assert json.loads(r.read())["ok"] is True
        with urllib.request.urlopen(f"{base}/ready", timeout=30) as r:
            assert json.loads(r.read())["shards"] == 2
        q = {"query": {"requestedGranularity": "record",
                       "includeResultsetResponses": "HIT",
                       "requestParameters": {
                           "assemblyId": "GRCh38", "referenceName": "22",
                           "start": [0, 10_000_000],
                           "end": [0, 10_000_000],
                           "alternateBases": "N"}}}
        req = urllib.request.Request(
            f"{base}/g_variants", data=json.dumps(q).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())
        status, want = japp.handle("POST", "/g_variants", body=q)
        assert status == 200 and want["responseSummary"]["exists"]
        assert dumped(got, "/g_variants") == dumped(want, "/g_variants")
        child.send_signal(signal.SIGINT)
        assert child.wait(timeout=30) == 0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        child.stdout.close()
        errors.close()
        close_jax(japp)
