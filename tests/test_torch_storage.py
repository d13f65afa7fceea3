"""The port's storage: the FileLock race repair and concurrent writers.

The JAX package's ``FileLock.release`` unlinks the lock file, so a waiter
that opened the old file and a fresh opener of the path could both hold an
exclusive flock (ROADMAP.md). The port's lock owns the flock only while the
path still names the file it locked. These tests check that without relying
on timing: the waiter's descriptor is opened before the holder releases.
"""

import os
import threading
import time

import numpy as np
import pytest

from waveformanalysis_tpu_torch.storage.memmap import FileLock, MemmapStorage


def test_release_cannot_admit_two_holders(tmp_path):
    path = tmp_path / "k.lock"
    holder = FileLock(path, timeout=0.2, retry_interval=0.01)
    holder.acquire()
    waiter_fh = open(path, "a+")  # a waiter opened the file before release
    try:
        waiter = FileLock(path)
        assert not waiter._try_lock(waiter_fh)  # still held
        holder.release()
        fresh = FileLock(path, timeout=0.2, retry_interval=0.01)
        fresh.acquire()  # a new opener takes the lock on a new file ...
        try:
            # ... and the waiter, whose flock on the old (unlinked) file
            # would now succeed, must not own the lock beside it
            assert not waiter._try_lock(waiter_fh)
            busy = FileLock(path, timeout=0.05, retry_interval=0.01)
            with pytest.raises(Exception, match="Timed out"):
                busy.acquire()
        finally:
            fresh.release()
    finally:
        waiter_fh.close()
    assert not path.exists()  # the last release removes the file


def test_lock_file_of_a_dead_holder_is_reused(tmp_path):
    """A lock file left behind (its holder died without release) holds no
    flock, so the next acquirer takes it as it is."""
    path = tmp_path / "k.lock"
    path.write_text("12345 0.0\n")
    old = os.stat(path).st_ino
    lock = FileLock(path, timeout=0.2, retry_interval=0.01)
    lock.acquire()
    assert os.stat(path).st_ino == old
    lock.release()
    assert not path.exists()


def test_delete_keeps_a_held_lock_file(tmp_path):
    storage = MemmapStorage(str(tmp_path))
    storage.save_memmap("k", np.arange(10), run_id="r")
    lock_path = storage._lock_path("k", "r")
    with FileLock(lock_path):
        storage.delete("k", run_id="r")
        assert lock_path.exists()  # still the holder's file
        assert not storage.exists("k", run_id="r")


@pytest.mark.parametrize("round_", range(3))
def test_same_key_thread_writers_last_wins_cleanly(tmp_path, round_):
    """Port of tests/test_storage_robustness.py's contended-writer test,
    repeated in a short loop: every save completes and the stored payload is
    always one writer's whole array."""
    storage = MemmapStorage(str(tmp_path))
    payloads = {seed: np.full(100, seed, np.int64) for seed in range(40)}
    errors = []
    deadline = time.monotonic() + 3.0

    def writer(first):
        try:
            for seed in range(first, 40, 4):
                if time.monotonic() > deadline:
                    return
                storage.save_memmap("contended", payloads[seed], run_id="r")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    for _ in range(5):
        threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert not errors
        out = np.asarray(storage.load_memmap("contended", run_id="r"))
        assert len(out) == 100 and (out == out[0]).all()  # one whole payload
        assert not list((tmp_path / "r" / "_cache").glob("*.tmp"))
