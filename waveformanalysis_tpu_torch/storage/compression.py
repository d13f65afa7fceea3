"""Pluggable compression codecs for cached blobs.

Behavioral analog of the reference compression layer
(reference: waveform_analysis/core/storage/compression.py:72-321): blosc2 /
lz4 / zstd / gzip codecs behind a CompressionManager; compressed entries lose
memmap zero-copy and are loaded fully (reference: memmap.py:615).
"""

from __future__ import annotations

import gzip as _gzip
import importlib
from typing import Dict, List, Optional

_CODEC_CACHE: Dict[str, "Codec"] = {}


class Codec:
    name = "none"

    def available(self) -> bool:
        return True

    def compress(self, data: bytes, level: int = 3) -> bytes:
        return data

    def decompress(self, data: bytes) -> bytes:
        return data


class GzipCodec(Codec):
    name = "gzip"

    def compress(self, data: bytes, level: int = 3) -> bytes:
        return _gzip.compress(data, compresslevel=level)

    def decompress(self, data: bytes) -> bytes:
        return _gzip.decompress(data)


class _OptionalModuleCodec(Codec):
    module_name = ""

    def __init__(self) -> None:
        self._mod = None
        try:
            self._mod = importlib.import_module(self.module_name)
        except ImportError:
            self._mod = None

    def available(self) -> bool:
        return self._mod is not None


class Lz4Codec(_OptionalModuleCodec):
    name = "lz4"
    module_name = "lz4.frame"

    def compress(self, data: bytes, level: int = 3) -> bytes:
        return self._mod.compress(data, compression_level=level)

    def decompress(self, data: bytes) -> bytes:
        return self._mod.decompress(data)


class ZstdCodec(_OptionalModuleCodec):
    name = "zstd"
    module_name = "zstandard"

    def compress(self, data: bytes, level: int = 3) -> bytes:
        return self._mod.ZstdCompressor(level=level).compress(data)

    def decompress(self, data: bytes) -> bytes:
        return self._mod.ZstdDecompressor().decompress(data)


class Blosc2Codec(_OptionalModuleCodec):
    name = "blosc2"
    module_name = "blosc2"

    def compress(self, data: bytes, level: int = 3) -> bytes:
        return self._mod.compress2(data, clevel=level)

    def decompress(self, data: bytes) -> bytes:
        return self._mod.decompress2(data)


_ALL_CODECS = {
    "none": Codec,
    "gzip": GzipCodec,
    "lz4": Lz4Codec,
    "zstd": ZstdCodec,
    "blosc2": Blosc2Codec,
}


def get_codec(name: str) -> Codec:
    if name not in _CODEC_CACHE:
        if name not in _ALL_CODECS:
            raise ValueError(f"Unknown compression codec: {name}")
        _CODEC_CACHE[name] = _ALL_CODECS[name]()
    codec = _CODEC_CACHE[name]
    if not codec.available():
        raise ValueError(f"Compression codec '{name}' is not available")
    return codec


class CompressionManager:
    """Chooses and applies a codec; records the codec in metadata."""

    def __init__(self, default_codec: str = "none", level: int = 3) -> None:
        self.default_codec = default_codec
        self.level = level

    @staticmethod
    def available_codecs() -> List[str]:
        out = []
        for name, cls in _ALL_CODECS.items():
            try:
                codec = get_codec(name)
                if codec.available():
                    out.append(name)
            except ValueError:
                continue
        return out

    def compress(self, data: bytes, codec: Optional[str] = None) -> tuple:
        """Returns (compressed_bytes, codec_name)."""
        name = codec or self.default_codec
        if name in (None, "none"):
            return data, "none"
        return get_codec(name).compress(data, self.level), name

    def decompress(self, data: bytes, codec: str) -> bytes:
        if codec in (None, "none"):
            return data
        return get_codec(codec).decompress(data)
