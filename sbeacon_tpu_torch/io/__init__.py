"""Byte sources of the port: local files and ranged HTTP/S3 reads.

Counterpart of ``sbeacon_tpu/io/__init__.py``, copied whole.
"""


from .sources import (
    ByteSource,
    HttpRangeSource,
    LocalFileSource,
    RemoteIOError,
    is_remote,
    open_source,
    read_bytes,
)

__all__ = [
    "ByteSource",
    "HttpRangeSource",
    "LocalFileSource",
    "RemoteIOError",
    "is_remote",
    "open_source",
    "read_bytes",
]
