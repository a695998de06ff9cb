"""Pluggable ranged-read byte sources: the object-store data plane.

Counterpart of ``sbeacon_tpu/io/sources.py``, copied whole.

The reference's defining I/O pattern is VCFs and index slices living in
object storage, read by concurrent ranged GETs (reference:
lambda/summariseSlice/source/downloader.h:70-91 one ranged GET per
thread; vcf_chunk_reader.h:69-105 4-thread download ring;
performQuery/search_variants.py:42-50 ``bcftools query s3://...``).
This module re-homes that capability behind one small interface:

    source = open_source("http://host/cohort/chr1.vcf.gz")
    source.read_range(start, end)          # one ranged GET
    source.read_range(start, end, workers=4)  # chunked concurrent GETs

Supported schemes:

- local paths (no scheme or ``file://``) — mmap-free plain reads;
- ``http(s)://`` — HTTP Range requests with retries; servers that ignore
  Range fall back to a cached whole-object GET;
- ``s3://bucket/key`` — mapped onto the HTTP backend against an
  S3-compatible endpoint (``BEACON_S3_ENDPOINT``, path-style; defaults
  to the real AWS endpoint for the configured region when unset and
  SigV4 credentials are present), with per-request **AWS SigV4
  signing** (``io/sigv4.py``) when ``BEACON_S3_ACCESS_KEY`` /
  ``BEACON_S3_SECRET_KEY`` are configured — private buckets work
  without a gateway, re-homing the reference's IAM-role data plane
  (reference: iam.tf:4-868; performQuery/search_variants.py:42-50).
  A static ``Authorization`` header (``BEACON_S3_TOKEN``) remains for
  bearer-authenticating S3-compatibles, and presigned/anonymous URLs
  keep working with neither configured.

Every read retries transient failures (the reference wraps each S3 GET
in a retry loop, shared/awsutils.cpp:62-65).
"""

from __future__ import annotations

import os
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from urllib.parse import urlparse


class RemoteIOError(IOError):
    """A remote object is unreachable/missing (400/404 at the API edge).

    ``status`` carries the HTTP code when one was received (None for
    transport failures) so callers can tell "definitively absent" (404)
    from "store said no / store unreachable" — conflating them turns an
    auth or endpoint problem into a misleading missing-file report."""

    def __init__(self, message: str, status: int | None = None):
        super().__init__(message)
        self.status = status


_SCHEMES = ("http://", "https://", "s3://")


def is_remote(location: str | Path) -> bool:
    return str(location).startswith(_SCHEMES)


def resolve_s3(url: str):
    """s3://bucket/key -> (http url, headers, signer|None) via the
    configured S3-compatible endpoint. With SigV4 credentials in the
    environment and no explicit endpoint, the real AWS regional
    endpoint is assumed (path-style)."""
    from .sigv4 import signer_from_env

    signer = signer_from_env()
    endpoint = os.environ.get("BEACON_S3_ENDPOINT", "")
    if not endpoint:
        if signer is None:
            raise RemoteIOError(
                f"cannot read {url}: set BEACON_S3_ENDPOINT to an "
                "S3-compatible HTTP endpoint (path-style), or configure "
                "BEACON_S3_ACCESS_KEY/BEACON_S3_SECRET_KEY for AWS SigV4"
            )
        endpoint = f"https://s3.{signer.region}.amazonaws.com"
    # split bucket/key WITHOUT urlparse: a '#' or '?' in an object key is
    # literal key material for S3, not a fragment/query delimiter
    rest = url[len("s3://"):]
    bucket, _, key = rest.partition("/")
    from urllib.parse import quote

    # percent-encode the key exactly once; the signer uses this same
    # encoded wire path verbatim as the canonical URI, so wire and
    # canonical forms cannot diverge for reserved characters
    enc_key = quote(key, safe="/-._~")
    headers = {}
    token = os.environ.get("BEACON_S3_TOKEN", "")
    if token and signer is None:
        # a static Authorization header would collide with the SigV4
        # Authorization; credentials take precedence when both are set
        headers["Authorization"] = token
    return (
        f"{endpoint.rstrip('/')}/{bucket}/{enc_key}",
        headers,
        signer,
    )


class ByteSource:
    """Random-access byte reads over one object."""

    location: str

    def exists(self) -> bool:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def read_range(self, start: int, end: int, *, workers: int = 1) -> bytes:
        """Bytes in [start, end) (clamped to the object's size)."""
        raise NotImplementedError

    def read_all(self) -> bytes:
        return self.read_range(0, self.size())


class LocalFileSource(ByteSource):
    def __init__(self, path: str | Path):
        self.location = str(path)
        self._path = Path(path)

    def exists(self) -> bool:
        return self._path.exists()

    def size(self) -> int:
        return self._path.stat().st_size

    def read_range(self, start: int, end: int, *, workers: int = 1) -> bytes:
        with open(self._path, "rb") as fh:
            fh.seek(start)
            return fh.read(max(0, end - start))

    def read_all(self) -> bytes:
        return self._path.read_bytes()


class HttpRangeSource(ByteSource):
    """HTTP(S) object with Range reads, retries, and concurrent chunking.

    The ``workers`` path is the downloader.h role: [start, end) split into
    ``chunk_bytes`` pieces fetched by a thread pool, reassembled in order.
    A server that answers 200 to a Range request (no range support) gets
    one whole-object GET whose body is cached for later reads.
    """

    def __init__(
        self,
        url: str,
        *,
        headers: dict | None = None,
        retries: int = 3,
        timeout_s: float = 60.0,
        chunk_bytes: int = 8 * 1024 * 1024,
        max_object_bytes: int | None = None,
    ):
        self.location = url
        self._signer = None
        if url.startswith("s3://"):
            url, s3_headers, self._signer = resolve_s3(url)
            headers = {**s3_headers, **(headers or {})}
        self._url = url
        self._headers = dict(headers or {})
        self._retries = retries
        self._timeout_s = timeout_s
        self._chunk_bytes = chunk_bytes
        # budget for whole-body reads (Range-less servers): a hostile or
        # misconfigured endpoint streaming an unbounded 200 body must be
        # cut off at the cap, not read into memory first
        self._max_object_bytes = max_object_bytes
        self._size: int | None = None
        self._whole: bytes | None = None  # cache when Range is unsupported

    def _read_capped(self, resp) -> bytes:
        cap = self._max_object_bytes
        if cap is None:
            return resp.read()
        cl = resp.headers.get("Content-Length")
        if cl and cl.isdigit() and int(cl) > cap:
            raise RemoteIOError(
                f"{self.location}: object is {cl} bytes (limit {cap})"
            )
        body = resp.read(cap + 1)
        if len(body) > cap:
            raise RemoteIOError(
                f"{self.location}: object exceeds {cap} bytes"
            )
        return body

    # -- low-level ----------------------------------------------------------

    def _request(self, extra_headers: dict, method: str = "GET"):
        headers = {**self._headers, **extra_headers}
        if self._signer is not None:
            # per-request SigV4: the signature covers every header sent
            # (incl. this request's Range), so each chunked GET signs
            # itself — signer is stateless/thread-safe for the pool
            headers = self._signer.sign(method, self._url, headers)
        req = urllib.request.Request(
            self._url, headers=headers, method=method
        )
        return urllib.request.urlopen(req, timeout=self._timeout_s)

    def _with_retries(self, fn):
        last: Exception | None = None
        for attempt in range(self._retries + 1):
            try:
                return fn()
            except urllib.error.HTTPError as e:
                if e.code in (404, 403, 401, 416):
                    raise RemoteIOError(
                        f"{self.location}: HTTP {e.code}", status=e.code
                    ) from e
                last = e
            except Exception as e:  # connection resets, timeouts
                last = e
            if attempt < self._retries:
                time.sleep(min(0.2 * (attempt + 1), 1.0))
        raise RemoteIOError(f"{self.location}: {last}") from last

    # -- ByteSource ---------------------------------------------------------

    def exists(self) -> bool:
        """True/False only for a definitive verdict; auth rejections and
        transport failures RAISE so callers never mistake a broken token
        or endpoint for a missing object."""
        try:
            self.size()
            return True
        except RemoteIOError as e:
            if e.status == 404:
                return False
            raise

    def size(self) -> int:
        if self._size is not None:
            return self._size
        if self._whole is not None:
            self._size = len(self._whole)
            return self._size

        def probe():
            # a 1-byte ranged GET beats HEAD: it also tells us whether the
            # server honours Range at all
            with self._request({"Range": "bytes=0-0"}) as resp:
                if resp.status == 206:
                    cr = resp.headers.get("Content-Range", "")
                    if "/" in cr:
                        return int(cr.rsplit("/", 1)[1]), None
                    # 206 without a parseable Content-Range: the 1-byte
                    # body must NOT be cached as the whole object —
                    # fall through to a plain full GET below
                else:
                    # 200: server ignored Range — body is the whole object
                    body = self._read_capped(resp)
                    return len(body), body
            with self._request({}) as resp:
                body = self._read_capped(resp)
                return len(body), body

        n, body = self._with_retries(probe)
        self._size = n
        if body is not None:
            self._whole = body
        return n

    def _get_range(self, start: int, end: int) -> bytes:
        def fetch():
            hdr = {"Range": f"bytes={start}-{end - 1}"}
            with self._request(hdr) as resp:
                if resp.status == 206:
                    return resp.read()
                # 200: server ignored Range — body is the whole object
                body = self._read_capped(resp)
                self._whole = body
                self._size = len(body)
                return body[start:end]

        return self._with_retries(fetch)

    def read_range(self, start: int, end: int, *, workers: int = 1) -> bytes:
        end = min(end, self.size())
        start = min(start, end)
        if end <= start:
            return b""
        if self._whole is not None:
            return self._whole[start:end]
        n = end - start
        if workers <= 1 or n <= self._chunk_bytes:
            return self._get_range(start, end)
        bounds = list(range(start, end, self._chunk_bytes)) + [end]
        with ThreadPoolExecutor(min(workers, len(bounds) - 1)) as pool:
            parts = list(
                pool.map(
                    lambda se: self._get_range(*se),
                    zip(bounds[:-1], bounds[1:]),
                )
            )
        return b"".join(parts)


def open_source(location: str | Path, **kwargs) -> ByteSource:
    loc = str(location)
    if loc.startswith(("http://", "https://", "s3://")):
        return HttpRangeSource(loc, **kwargs)
    if loc.startswith("file://"):
        return LocalFileSource(loc[len("file://"):])
    return LocalFileSource(loc)


def read_bytes(location: str | Path) -> bytes:
    """Whole-object read for any supported scheme (small control files:
    .tbi/.csi indexes, portable region files)."""
    return open_source(location).read_all()
