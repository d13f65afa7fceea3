"""Storage layer: memmap cache backend, protocol, compression, integrity."""

from waveformanalysis_tpu_torch.storage.backends import (
    REQUIRED_BACKEND_METHODS,
    SQLiteBackend,
    StorageBackend,
    validate_backend,
)
from waveformanalysis_tpu_torch.storage.cache_manager import RuntimeCacheManager
from waveformanalysis_tpu_torch.storage.compression import CompressionManager, get_codec
from waveformanalysis_tpu_torch.storage.integrity import IntegrityChecker, checksum_file
from waveformanalysis_tpu_torch.storage.memmap import (
    BufferedStreamWriter,
    FileLock,
    MemmapStorage,
    STORAGE_VERSION,
)

__all__ = [
    "MemmapStorage",
    "FileLock",
    "BufferedStreamWriter",
    "STORAGE_VERSION",
    "StorageBackend",
    "SQLiteBackend",
    "validate_backend",
    "REQUIRED_BACKEND_METHODS",
    "CompressionManager",
    "get_codec",
    "IntegrityChecker",
    "checksum_file",
    "RuntimeCacheManager",
]
