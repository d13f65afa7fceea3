"""File integrity checking.

Behavioral analog of the reference IntegrityChecker
(reference: waveform_analysis/core/storage/integrity.py:31): xxhash64 when
available (fast), falling back to sha256/md5; helpers to checksum files,
verify against stored metadata, and scan directories.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

_CHUNK = 4 * 1024 * 1024

try:
    import xxhash  # type: ignore

    _HAS_XXHASH = True
except ImportError:
    xxhash = None
    _HAS_XXHASH = False


def available_algorithms() -> List[str]:
    algos = []
    if _HAS_XXHASH:
        algos.append("xxhash64")
    algos.extend(["sha256", "md5"])
    return algos


def preferred_algorithm() -> str:
    return "xxhash64" if _HAS_XXHASH else "sha256"


def _new_hasher(algorithm: str):
    if algorithm == "xxhash64":
        if not _HAS_XXHASH:
            raise ValueError("xxhash not available")
        return xxhash.xxh64()
    if algorithm == "sha256":
        return hashlib.sha256()
    if algorithm == "md5":
        return hashlib.md5()
    raise ValueError(f"Unknown checksum algorithm: {algorithm}")


def checksum_file(path: Union[str, Path], algorithm: Optional[str] = None) -> Tuple[str, str]:
    """Return (algorithm, hexdigest) for a file."""
    algorithm = algorithm or preferred_algorithm()
    h = _new_hasher(algorithm)
    with open(path, "rb") as fh:
        while True:
            block = fh.read(_CHUNK)
            if not block:
                break
            h.update(block)
    return algorithm, h.hexdigest()


def checksum_bytes(data: bytes, algorithm: Optional[str] = None) -> Tuple[str, str]:
    algorithm = algorithm or preferred_algorithm()
    h = _new_hasher(algorithm)
    h.update(data)
    return algorithm, h.hexdigest()


class IntegrityChecker:
    """Checksums files and verifies them against stored metadata."""

    def __init__(self, algorithm: Optional[str] = None) -> None:
        self.algorithm = algorithm or preferred_algorithm()

    def compute(self, path: Union[str, Path]) -> Dict[str, str]:
        algo, digest = checksum_file(path, self.algorithm)
        return {"algorithm": algo, "value": digest}

    def verify(self, path: Union[str, Path], expected: Dict[str, str]) -> bool:
        """Verify a file against {"algorithm": ..., "value": ...} metadata."""
        if not expected or "value" not in expected:
            return True  # nothing to check against
        algo = expected.get("algorithm", self.algorithm)
        try:
            _, digest = checksum_file(path, algo)
        except (OSError, ValueError):
            return False
        return digest == expected["value"]

    def scan_directory(
        self, directory: Union[str, Path], pattern: str = "*.bin"
    ) -> Dict[str, Dict[str, str]]:
        """Checksum every matching file under a directory."""
        out: Dict[str, Dict[str, str]] = {}
        for path in sorted(Path(directory).rglob(pattern)):
            try:
                out[str(path)] = self.compute(path)
            except OSError:
                continue
        return out
