"""Scalar SQL UDFs: the Athena-UDF Lambda re-homed onto the sqlite store.

Counterpart of ``sbeacon_tpu/metadata/udfs.py``, copied whole.

The reference ships a Java Lambda exposing four scalar UDFs to Athena —
zlib ``compress``/``decompress`` (Base64-wrapped) and AES
``encrypt``/``decrypt`` with a Base64 data key fetched from Secrets
Manager (reference: lambda/udfs/src/main/java/com/amazonaws/athena/
connectors/udfs/AthenaUDFHandler.java:69-204, deployed by udfs.tf:26-42;
present but unreferenced by any query — carried as optional, SURVEY.md
§2.1). Here the same four functions are plain Python callables plus a
``register_udfs`` hook that installs them as sqlite scalar functions on
the metadata store's connection, so metadata SQL can use them exactly the
way Athena SQL would.

Wire-format parity: ``compress`` is raw zlib (Java ``Deflater`` default)
Base64'd; ``encrypt`` is AES/ECB/PKCS5Padding (Java ``Cipher.getInstance
("AES")`` default) over a Base64-decoded key. ECB is a weak mode — kept
because the wire format is the parity contract; prefer the additionally
provided GCM pair for new data.
"""

from __future__ import annotations

import base64
import os
import zlib
from typing import Callable

#: secrets provider signature (the CachableSecretsManager role): secret
#: name -> Base64-encoded AES data key string
SecretsProvider = Callable[[str], str]


def env_secrets(name: str) -> str:
    """Default provider: key material from SBEACON_SECRET_{NAME}."""
    key = os.environ.get(f"SBEACON_SECRET_{name.upper().replace('-', '_')}")
    if key is None:
        raise KeyError(f"secret {name!r} not configured")
    return key


def compress(text: str) -> str:
    """Base64(zlib(text)) — AthenaUDFHandler.compress."""
    return base64.b64encode(zlib.compress(text.encode())).decode()


def decompress(data: str) -> str:
    """Inverse of :func:`compress` — AthenaUDFHandler.decompress."""
    return zlib.decompress(base64.b64decode(data)).decode()


def _aes_ecb(key_b64: str):
    from cryptography.hazmat.primitives.ciphers import (
        Cipher,
        algorithms,
        modes,
    )

    key = base64.b64decode(key_b64)
    return Cipher(algorithms.AES(key), modes.ECB())


def encrypt(plaintext: str, secret_name: str, secrets: SecretsProvider = env_secrets) -> str:
    """AES/ECB/PKCS5 + Base64 — AthenaUDFHandler.encrypt wire format."""
    from cryptography.hazmat.primitives import padding

    padder = padding.PKCS7(128).padder()
    padded = padder.update(plaintext.encode()) + padder.finalize()
    enc = _aes_ecb(secrets(secret_name)).encryptor()
    return base64.b64encode(enc.update(padded) + enc.finalize()).decode()


def decrypt(ciphertext: str, secret_name: str, secrets: SecretsProvider = env_secrets) -> str:
    """Inverse of :func:`encrypt` — AthenaUDFHandler.decrypt."""
    from cryptography.hazmat.primitives import padding

    dec = _aes_ecb(secrets(secret_name)).decryptor()
    padded = dec.update(base64.b64decode(ciphertext)) + dec.finalize()
    unpadder = padding.PKCS7(128).unpadder()
    return (unpadder.update(padded) + unpadder.finalize()).decode()


def encrypt_gcm(plaintext: str, secret_name: str, secrets: SecretsProvider = env_secrets) -> str:
    """Authenticated alternative (not in the reference): Base64 of
    nonce || AES-GCM ciphertext+tag."""
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    key = base64.b64decode(secrets(secret_name))
    nonce = os.urandom(12)
    ct = AESGCM(key).encrypt(nonce, plaintext.encode(), None)
    return base64.b64encode(nonce + ct).decode()


def decrypt_gcm(ciphertext: str, secret_name: str, secrets: SecretsProvider = env_secrets) -> str:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    key = base64.b64decode(secrets(secret_name))
    raw = base64.b64decode(ciphertext)
    return AESGCM(key).decrypt(raw[:12], raw[12:], None).decode()


def register_udfs(store, secrets: SecretsProvider = env_secrets) -> None:
    """Install the four UDFs (plus the GCM pair) as sqlite scalar
    functions on a MetadataStore — the udfs.tf deployment step."""
    conn = store.conn
    conn.create_function("compress", 1, compress, deterministic=True)
    conn.create_function("decompress", 1, decompress, deterministic=True)
    conn.create_function(
        "encrypt", 2, lambda p, s: encrypt(p, s, secrets), deterministic=True
    )
    conn.create_function(
        "decrypt", 2, lambda c, s: decrypt(c, s, secrets), deterministic=True
    )
    conn.create_function(
        "encrypt_gcm", 2, lambda p, s: encrypt_gcm(p, s, secrets)
    )
    conn.create_function(
        "decrypt_gcm", 2, lambda c, s: decrypt_gcm(c, s, secrets)
    )
