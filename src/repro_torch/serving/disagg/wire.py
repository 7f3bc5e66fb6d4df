"""Wire format of shipped decode states: the JAX package's
``serving/disagg/wire.py`` for the port's tensors, byte for byte.

A blob is a self-describing serialization of one batch-1 decode state
(nested dicts/lists of tensors: STLT ``h_re``/``h_im`` carries and the
adaptive ``asum``/``acnt``, attention KV caches, rg-LRU and xLSTM states):
the magic ``STLTWIRE``, a fixed ``<HHII`` header (version 1, flags, header
and meta lengths), a JSON leaf table (tree path, logical dtype, stored
dtype, shape, payload offset) padded with spaces to a multiple of 64 bytes,
the sender's JSON meta padded to a multiple of 256 (so the blob's size does
not depend on it), and the concatenated little-endian leaf payload. Leaves
go in the JAX package's flatten order (dict keys sorted), so a state
converted from the JAX package (``convert.from_jax_state``, unstacked
layers) packs to the JAX package's blob, and blobs cross-unpack both ways.
An STLT state is O(S*d) whatever the prompt length: the blob size is the
paper's flat-bytes property made measurable.

``store="bf16"`` narrows float32 leaves to bfloat16 on the wire
(``Tensor.to`` rounds to nearest even, as ``ml_dtypes`` does, so the
payload is the JAX package's); ``unpack_state`` widens them back to
float32. bf16 -> f32 -> bf16 is exact, so a round trip re-packs to the same
blob. bfloat16 travels as raw 16-bit patterns named ``"bfloat16"``.

The digest in the header is ``prefix_cache.state_digest`` of the logical
(widened) leaves, so a receiver can insert the unpacked state into a
prefix cache without hashing it again. ``unpack_state`` verifies it by
default: a blob corrupted in flight that still parses is refused with
``ValueError``, the one exception every failure here raises (bad magic or
version, truncation, a bad compressed payload, a digest mismatch).

``compress="zstd"`` deflates the payload (the header and meta stay plain,
so magic and version are checked first) with zstd when the ``zstandard``
module is present and with the standard library's zlib otherwise; the
header records the codec that ran.
"""
from __future__ import annotations

import json
import struct
import zlib

import numpy as np
import torch

from repro_torch.serving.prefix_cache import (dequantize_tree, host_bytes,  # noqa: F401
                                              quantize_tree, state_digest)
from repro_torch.utils import jax_order

try:  # optional: zlib is the fallback
    import zstandard as _zstd
except ImportError:  # pragma: no cover - depends on the installation
    _zstd = None

MAGIC = b"STLTWIRE"
VERSION = 1
_STORES = ("f32", "bf16")
_COMPRESS = (None, "zstd")
_FLAG_COMPRESSED = 1
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                 "float32": torch.float32, "float64": torch.float64,
                 "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
                 "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def wire_codec(compress: str | None) -> str | None:
    """The codec a ``compress=`` request runs: ``"zstd"`` when the zstandard
    module is present, else ``"zlib"``; None for no compression."""
    if compress is None:
        return None
    if compress not in _COMPRESS:
        raise ValueError(f"compress must be one of {_COMPRESS} (got {compress!r})")
    return "zstd" if _zstd is not None else "zlib"


def _compress_bytes(codec: str, raw: bytes) -> bytes:
    if codec == "zstd":
        return _zstd.ZstdCompressor(level=3).compress(raw)
    return zlib.compress(raw, 6)


def _decompress_bytes(codec: str, raw: bytes, n: int) -> bytes:
    try:
        if codec == "zstd":
            if _zstd is None:
                raise ValueError("blob is zstd-compressed but no zstandard module is "
                                 "available in this environment")
            return _zstd.ZstdDecompressor().decompress(raw, max_output_size=n)
        if codec == "zlib":
            return zlib.decompress(raw)
        raise ValueError(f"unknown wire codec {codec!r}")
    except ValueError:
        raise
    except Exception as e:   # zlib.error, zstd's errors
        raise ValueError(f"corrupt compressed wire payload: {e}") from e


def _flatten(tree, path=()) -> list:
    """(path steps, leaf) pairs: ``["k", key]`` a dict step, ``["i", index]``
    a list step, as the JAX package encodes its pytree paths."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _flatten(v, path + (["k", k],))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _flatten(v, path + (["i", i],))]
    return [(list(path), tree)]


def pack_state(state, *, store: str = "f32", meta: dict | None = None,
               compress: str | None = None) -> bytes:
    """Serialize a decode state (nested dicts/lists of tensors on any
    device). ``store="bf16"`` narrows float32 leaves; other leaves are
    stored as they are. ``meta`` is a JSON-serializable dict carried in its
    own segment. ``compress="zstd"`` deflates the payload (the compressed
    size is no longer flat in prompt length; the digest still is)."""
    if store not in _STORES:
        raise ValueError(f"store must be one of {_STORES} (got {store!r})")
    codec = wire_codec(compress)
    table, chunks, logical = [], [], []
    offset = 0
    for path, leaf in _flatten(jax_order(state)):
        t = torch.as_tensor(leaf).detach().cpu()
        stored = t.to(torch.bfloat16) if store == "bf16" and t.dtype == torch.float32 else t
        shape, _, raw = host_bytes(stored)
        # the digest is of the logical (widened) content, stable across any
        # number of round trips
        logical.append(stored.float() if stored is not t else t)
        table.append({"path": path, "shape": list(shape), "dtype": _NAMES[t.dtype],
                      "store": _NAMES[stored.dtype], "offset": offset, "nbytes": len(raw)})
        chunks.append(raw)
        offset += len(raw)
    digest = state_digest(logical)
    flags = 0
    payload = b"".join(chunks)
    hdr = {"version": VERSION, "store": store, "digest": digest.hex(), "leaves": table}
    if codec is not None:
        flags |= _FLAG_COMPRESSED
        hdr["codec"] = codec
        hdr["raw_nbytes"] = len(payload)
        payload = _compress_bytes(codec, payload)
    header = json.dumps(hdr).encode()
    header += b" " * (-len(header) % 64)
    meta_seg = json.dumps(meta or {}).encode()
    meta_seg += b" " * (-len(meta_seg) % 256)
    return b"".join([MAGIC, struct.pack("<HHII", VERSION, flags, len(header), len(meta_seg)),
                     header, meta_seg, payload])


def _rebuild(entries):
    """Nested dict/list tree from (path steps, leaf) pairs."""
    if not entries:
        return {}
    if not entries[0][0]:
        if len(entries) != 1:
            raise ValueError("multiple leaves at the tree root")
        return entries[0][1]
    by_key: dict = {}
    kinds = set()
    for steps, leaf in entries:
        kind, key = steps[0]
        kinds.add(kind)
        by_key.setdefault((kind, key), []).append((steps[1:], leaf))
    if kinds == {"i"}:
        idxs = sorted(k for _, k in by_key)
        if idxs != list(range(len(idxs))):
            raise ValueError(f"non-contiguous list indices {idxs}")
        return [_rebuild(by_key[("i", i)]) for i in idxs]
    if kinds == {"k"}:
        return {k: _rebuild(v) for (_, k), v in by_key.items()}
    raise ValueError("mixed dict/list keys at one tree level")


def _leaf(payload: bytes, ent: dict) -> torch.Tensor:
    """One stored leaf of the payload as a tensor in its logical dtype."""
    lo, n = ent["offset"], ent["nbytes"]
    if lo + n > len(payload):
        raise ValueError("truncated wire blob")
    try:
        store = _TORCH_DTYPES[ent["store"]]
        logical = _TORCH_DTYPES[ent["dtype"]]
    except KeyError as e:
        raise ValueError(f"unknown wire dtype {e}") from e
    count = int(np.prod(ent["shape"], dtype=np.int64)) if ent["shape"] else 1
    raw = np.frombuffer(payload, dtype=np.int16 if store == torch.bfloat16 else
                        np.dtype(ent["store"]), count=count, offset=lo)
    t = torch.from_numpy(raw.copy()).reshape(ent["shape"])
    if store == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(logical) if t.dtype != logical else t


def unpack_state(blob: bytes, verify: bool = True, device="cpu"):
    """Inverse of :func:`pack_state`: ``(state, digest, meta)``. ``state``
    holds tensors on ``device`` in their logical dtypes (bf16-stored float32
    leaves come back float32), its dicts in sorted key order; ``digest`` is
    the header's ``state_digest`` (for ``PrefixCache.insert(digest=...)``);
    ``meta`` the sender's dict. ``verify`` recomputes the digest over the
    unpacked leaves and raises ``ValueError`` on a mismatch."""
    if blob[:len(MAGIC)] != MAGIC:
        raise ValueError("not a STLT wire blob (bad magic)")
    fixed = len(MAGIC) + struct.calcsize("<HHII")
    if len(blob) < fixed:
        raise ValueError("truncated wire blob")
    version, flags, hlen, mlen = struct.unpack("<HHII", blob[len(MAGIC):fixed])
    if version != VERSION:
        raise ValueError(f"unsupported wire version {version} (this build reads {VERSION})")
    if len(blob) < fixed + hlen + mlen:
        raise ValueError("truncated wire blob")
    try:
        header = json.loads(blob[fixed:fixed + hlen])
        meta = json.loads(blob[fixed + hlen:fixed + hlen + mlen]) if mlen else {}
    except json.JSONDecodeError as e:
        raise ValueError(f"corrupt wire header/meta: {e}") from e
    payload = blob[fixed + hlen + mlen:]
    if flags & _FLAG_COMPRESSED:
        payload = _decompress_bytes(header.get("codec", "zlib"), payload,
                                    int(header["raw_nbytes"]))
        if len(payload) != int(header["raw_nbytes"]):
            raise ValueError("truncated wire blob (decompressed size mismatch)")
    entries = [([tuple(s) for s in ent["path"]], _leaf(payload, ent))
               for ent in header["leaves"]]
    digest = bytes.fromhex(header["digest"])
    if verify and state_digest([leaf for _, leaf in entries]) != digest:
        raise ValueError("wire digest mismatch (corrupt payload)")
    device = torch.device(device)
    if device.type != "cpu":
        entries = [(p, leaf.to(device)) for p, leaf in entries]
    return _rebuild(entries), digest, meta
