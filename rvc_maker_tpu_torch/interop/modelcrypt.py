"""At-rest decryption for the reference's released model files.

The reference distributes its FCPE predictor files (fcpe.pt /
fcpe_legacy.pt and the .onnx variants) AES-256-CBC encrypted; the 32-byte
key ships with the reference itself at main/configs/decrypt.bin and the
layout is IV = first 16 bytes of the file, PKCS7-padded ciphertext after
(reference main/library/predictors/FCPE.py:28-40 `decrypt_model`).

The key below is that shipped key (it is distribution data, not code —
without it no released FCPE checkpoint can be opened).  Plain files pass
through untouched, so every loader can call `maybe_decrypt` blindly.

A copy of `rvc_maker_tpu/interop/modelcrypt.py`.  `cryptography` is
imported only inside the functions that decrypt or encrypt, since a
machine may lack it; an encrypted file there raises a clear error.
"""

from __future__ import annotations

# main/configs/decrypt.bin, hex-encoded (32 bytes = AES-256).
REFERENCE_MODEL_KEY = bytes.fromhex(
    "5ec540c17600fbc22913a7cf03b810bacedd9ac1aaa92e1445b43702dec43b2d")


def _aes():
    """(Cipher, algorithms, modes) of the `cryptography` package."""
    try:
        from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
    except ImportError as e:
        raise ImportError("encrypted model files (the released FCPE weights) need the "
                          "'cryptography' package, which is not installed") from e
    return Cipher, algorithms, modes


def encrypt_model_bytes(plain: bytes, key: bytes = REFERENCE_MODEL_KEY,
                        iv: bytes = b"\0" * 16) -> bytes:
    """Inverse of decrypt_model_bytes (for tests / re-publishing)."""
    Cipher, algorithms, modes = _aes()

    pad = 16 - len(plain) % 16
    enc = Cipher(algorithms.AES(key), modes.CBC(iv)).encryptor()
    return iv + enc.update(plain + bytes([pad]) * pad) + enc.finalize()


def decrypt_model_bytes(data: bytes,
                        key: bytes = REFERENCE_MODEL_KEY) -> bytes:
    """AES-256-CBC decrypt an encrypted model file (IV ++ ciphertext).

    Raises ValueError if the result is not valid PKCS7 (wrong key, or the
    file was never encrypted).
    """
    Cipher, algorithms, modes = _aes()

    if len(data) < 32 or (len(data) - 16) % 16:
        raise ValueError("not an encrypted model file (bad length)")
    dec = Cipher(algorithms.AES(key), modes.CBC(data[:16])).decryptor()
    plain = dec.update(data[16:]) + dec.finalize()
    pad = plain[-1]
    if not 1 <= pad <= 16 or plain[-pad:] != bytes([pad]) * pad:
        raise ValueError("bad PKCS7 padding — wrong key or plain file")
    return plain[:-pad]


def _looks_plain(data: bytes) -> bool:
    """True if data is already a recognisable model container."""
    if data[:2] == b"PK":                       # zip (torch >=1.6 .pt)
        return True
    if data[:1] == b"\x80":                     # bare pickle protocol 2+
        return True
    # ONNX pb: field 1 (ir_version) varint — accept any single-byte varint
    # value (ir_version 1-127 covers all released and future versions),
    # then require the NEXT byte to be a valid ModelProto field tag
    # (producer_name/version, domain, model_version, doc_string, graph,
    # opset_import, metadata_props...).  Without this second token check
    # ~1/512 of random ciphertexts would classify as "plain ONNX" and be
    # returned undecrypted, failing later with an opaque parse error.
    _MODELPROTO_TAGS = (0x12, 0x1a, 0x22, 0x28, 0x32, 0x3a, 0x42, 0x72,
                        0xa2)  # 0xa2 = first byte of field-20 training_info
    if (data[:1] == b"\x08" and len(data) > 2 and data[1] < 0x80
            and data[2] in _MODELPROTO_TAGS):
        return True
    return False


def maybe_decrypt(data: bytes, key: bytes = REFERENCE_MODEL_KEY) -> bytes:
    """Return data decrypted if it is an encrypted model file, else as-is."""
    if len(data) < 32 or _looks_plain(data):
        return data
    try:
        plain = decrypt_model_bytes(data, key)
    except ValueError:
        return data
    if not _looks_plain(plain):
        # Structurally valid PKCS7 but unrecognisable plaintext: either a
        # false-positive decrypt of some other binary format, or a container
        # this sniffer doesn't know.  Hand back the original, but say so —
        # a silent pass-through defers failure to an opaque parse error.
        import logging

        logging.getLogger(__name__).warning(
            "maybe_decrypt: decryption succeeded structurally but the "
            "plaintext is not a recognisable model container "
            "(first bytes %r); returning the file undecrypted",
            plain[:4])
        return data
    return plain
