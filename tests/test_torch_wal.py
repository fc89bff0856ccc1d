"""The port's write-ahead log (``repro_torch.serve.wal``) against the JAX
package's: the same bytes on disk from the same records, and each
package's ``scan_wal`` reading the other's clean, corrupt and torn files
alike (``valid_end``, ``torn_bytes``, the same error).  Then the WAL
layer's contracts of ``tests/test_sessions.py`` with the port alone."""

import os

import numpy as np
import pytest

from repro.serve import wal as jwal
from repro_torch import obs
from repro_torch.serve import wal

PACKAGES = {"torch": wal, "jax": jwal}

RECORDS = {
    "mixed": [(wal.OPEN, 0, b'{"schema": 1}'), (wal.APPEND, 1, b"row-one"),
              (wal.APPEND, 2, b""), (wal.APPEND, 3, b"x" * 1000)],
    "rows": [(wal.OPEN, 0, b"meta")] + [
        (wal.APPEND, i, np.random.default_rng(i).random(12).astype(np.float32).tobytes())
        for i in range(1, 9)],
}


def _write(mod, path, records, fsync=False):
    w = mod.WalWriter(str(path), fsync=fsync)
    for rtype, seq, payload in records:
        w.append(rtype, seq, payload)
    size = w.tell()
    w.close()
    return size


def test_framing_constants_match_the_jax_package():
    assert (wal._MAGIC, wal._HEADER.format, wal._HEADER.size, wal._MAX_PLEN,
            wal.OPEN, wal.APPEND) == (jwal._MAGIC, jwal._HEADER.format,
                                      jwal._HEADER.size, jwal._MAX_PLEN,
                                      jwal.OPEN, jwal.APPEND)
    assert wal._crc(1, 7, b"abc") == jwal._crc(1, 7, b"abc")


@pytest.mark.parametrize("fsync", [False, True])
@pytest.mark.parametrize("records", list(RECORDS))
def test_both_writers_write_the_same_bytes(tmp_path, records, fsync):
    a, b = tmp_path / "torch.log", tmp_path / "jax.log"
    assert _write(wal, a, RECORDS[records], fsync) == _write(
        jwal, b, RECORDS[records], fsync)
    assert a.read_bytes() == b.read_bytes()


def _damage(data: bytes, case: str) -> bytes:
    """The file a case leaves: clean, a flipped payload byte mid-log, a bad
    magic mid-log, or a tail torn mid-payload / mid-header."""
    rec = 21 + 48
    data = bytearray(data)
    if case == "clean":
        return bytes(data)
    if case == "crc":
        data[3 * rec + 21 + 10] ^= 0xFF
        return bytes(data)
    if case == "magic":
        data[2 * rec] ^= 0x01
        return bytes(data)
    if case == "torn_payload":
        return bytes(data[:-30])
    if case == "torn_header":
        return bytes(data[:-(48 + 10)])
    raise AssertionError(case)


CASES = ["clean", "crc", "magic", "torn_payload", "torn_header"]


def _outcome(mod, path, tolerate):
    try:
        scan = mod.scan_wal(str(path), tolerate_torn_tail=tolerate)
    except mod.WALTruncated:
        return "WALTruncated"
    except mod.WALCorrupt:
        return "WALCorrupt"
    return ([(r.rtype, r.seq, r.payload) for r in scan.records], scan.valid_end,
            scan.torn_bytes)


@pytest.mark.parametrize("tolerate", [False, True])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("writer", list(PACKAGES))
def test_each_package_reads_the_others_files_alike(tmp_path, writer, case, tolerate):
    """Rows of 48 bytes (12 float32), as the sessions write: every reader
    sees the same records, ``valid_end`` and ``torn_bytes``, or raises the
    same error, whichever package wrote the file."""
    recs = [(wal.OPEN, 0, bytes(48))] + [
        (wal.APPEND, i, bytes([i]) * 48) for i in range(1, 6)]
    path = tmp_path / "wal.log"
    _write(PACKAGES[writer], path, recs)
    path.write_bytes(_damage(path.read_bytes(), case))
    got = {name: _outcome(mod, path, tolerate) for name, mod in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    want = {"clean": 6, "torn_payload": 5, "torn_header": 5}
    if case in ("crc", "magic"):
        assert got["torch"] == "WALCorrupt"
    elif case == "clean" or tolerate:
        records, valid_end, torn = got["torch"]
        assert len(records) == want[case]
        assert valid_end == 69 * want[case]
        assert torn == os.path.getsize(path) - valid_end
    else:
        assert got["torch"] == "WALTruncated"


# -- the WAL layer's contracts, with the port alone ----------------------------


def test_wal_roundtrip(tmp_path):
    p = str(tmp_path / "wal.log")
    w = wal.WalWriter(p)
    payloads = [b"open-meta", b"row-one", b"", b"x" * 1000]
    for i, pl in enumerate(payloads):
        w.append(wal.OPEN if i == 0 else wal.APPEND, i, pl)
    size = w.tell()
    w.close()
    assert os.path.getsize(p) == size
    scan = wal.scan_wal(p)
    recs = scan.records
    assert scan.valid_end == size and scan.torn_bytes == 0
    assert [r.seq for r in recs] == [0, 1, 2, 3]
    assert [r.payload for r in recs] == payloads
    assert recs[0].rtype == wal.OPEN
    assert all(r.rtype == wal.APPEND for r in recs[1:])


def test_wal_checksum_corruption_fails_loudly(tmp_path):
    """A flipped bit mid-log raises WALCorrupt, tolerant or not: the suffix
    records after it are acknowledged data."""
    p = str(tmp_path / "wal.log")
    w = wal.WalWriter(p)
    for i in range(5):
        w.append(wal.APPEND, i, bytes([i]) * 32)
    w.close()
    data = bytearray(open(p, "rb").read())
    rec_size = len(data) // 5
    data[3 * rec_size - 10] ^= 0xFF
    open(p, "wb").write(bytes(data))
    with pytest.raises(wal.WALCorrupt):
        wal.scan_wal(p)
    with pytest.raises(wal.WALCorrupt) as ei:
        wal.scan_wal(p, tolerate_torn_tail=True)
    assert not isinstance(ei.value, wal.WALTruncated)


def test_wal_torn_tail(tmp_path):
    """EOF mid-final-record raises WALTruncated by default; tolerate_torn_tail
    returns the complete prefix and frames the partial rest."""
    p = str(tmp_path / "wal.log")
    w = wal.WalWriter(p)
    for i in range(4):
        w.append(wal.APPEND, i, bytes(64))
    w.close()
    full = open(p, "rb").read()
    rec_size = len(full) // 4
    for cut in (70, 30):  # mid-header and mid-payload of the last record
        open(p, "wb").write(full[: len(full) - cut])
        with pytest.raises(wal.WALTruncated):
            wal.scan_wal(p)
        scan = wal.scan_wal(p, tolerate_torn_tail=True)
        assert [r.seq for r in scan.records] == [0, 1, 2]
        assert scan.valid_end == 3 * rec_size
        assert scan.torn_bytes == rec_size - cut


def test_wal_histograms_land_on_the_ports_registry(tmp_path):
    obs.reset()
    _write(wal, tmp_path / "wal.log", RECORDS["mixed"], fsync=True)
    reg = obs.get_registry()
    assert reg.get("repro_wal_append_seconds").stats()["count"] == 4
    assert reg.get("repro_wal_fsync_seconds").stats()["count"] == 4
    obs.reset()
