"""The IFile CRC trailer (``IFileWriter(with_crc=True)``, ``crack(verify_crc=
True)``) of the port against the JAX package's ``uda_tpu.utils.ifile``.

Every case of ``tests/test_ifile.py::test_crc_trailer`` (a good trailer, a
flipped byte, a missing trailer) runs on both packages over the same
seeded records, with ``uda.tpu.use.native`` on and off and on both sides
of the native crack's threshold (``_NATIVE_THRESHOLD``, 4 KiB): the
written bytes must be the reference's, and each package must raise the
same ``StorageError`` message on the same bytes."""

import io
import zlib

import numpy as np
import pytest

from port_helpers import paired_gauges_settle  # noqa: F401
from uda_tpu.utils import ifile as jifile
from uda_tpu.utils.errors import StorageError as JStorageError
from uda_tpu_torch.utils import ifile
from uda_tpu_torch.utils.errors import StorageError

# one record (the reference test's), a segment just under the native
# threshold, and one well past it
SIZES = {"one": 1, "under": 20, "over": 400}


@pytest.fixture(params=[True, False], ids=["native", "python"])
def native_on(request):
    ifile.set_native_enabled(request.param)
    jifile.set_native_enabled(request.param)
    yield request.param
    ifile.set_native_enabled(True)
    jifile.set_native_enabled(True)


def _records(kind: str, seed: int = 7) -> list:
    if kind == "one":
        return [(b"k", b"v")]
    rng = np.random.default_rng(seed)
    return [(rng.bytes(int(rng.integers(0, 40))),
             rng.bytes(int(rng.integers(0, 200))))
            for _ in range(SIZES[kind])]


def _write(mod, recs: list, with_crc: bool = True) -> tuple:
    out = io.BytesIO()
    w = mod.IFileWriter(out, with_crc=with_crc)
    for k, v in recs:
        w.append(k, v)
    w.close()
    return out.getvalue(), w.bytes_written, w.records


def _raised(mod, err, raw: bytes) -> str:
    with pytest.raises(err) as e:
        mod.crack(raw, verify_crc=True)
    return str(e.value)


@pytest.mark.parametrize("kind", list(SIZES))
def test_trailer_bytes_are_the_references(kind, native_on):
    recs = _records(kind)
    raw, written, n = _write(ifile, recs)
    assert (raw, written, n) == _write(jifile, recs)
    assert written == len(raw)
    assert int.from_bytes(raw[-4:], "big") == zlib.crc32(raw[:-4])
    assert raw[:-4] == ifile.write_records(recs)
    if kind == "over":
        assert len(raw) >= ifile._NATIVE_THRESHOLD
    elif kind == "under":
        assert len(raw) < ifile._NATIVE_THRESHOLD
    # without the flag no trailer is written, as in the reference
    assert _write(ifile, recs, with_crc=False)[0] == raw[:-4]


@pytest.mark.parametrize("kind", list(SIZES))
def test_good_trailer_cracks_as_the_reference(kind, native_on):
    recs = _records(kind)
    raw = _write(ifile, recs)[0]
    got = ifile.crack(raw, verify_crc=True)
    want = jifile.crack(raw, verify_crc=True)
    assert got.num_records == want.num_records == len(recs)
    assert list(got.iter_records()) == list(want.iter_records()) == recs
    for col in ("key_off", "key_len", "val_off", "val_len"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
    # a trailed segment still cracks without the check, as in the reference
    assert list(ifile.crack(raw).iter_records()) == recs


@pytest.mark.parametrize("kind", list(SIZES))
def test_flipped_byte_raises_the_references_mismatch(kind, native_on):
    raw = bytearray(_write(ifile, _records(kind))[0])
    # a value byte of the last record: the framing stays valid
    raw[-8] ^= 1
    msg = _raised(ifile, StorageError, bytes(raw))
    assert msg == _raised(jifile, JStorageError, bytes(raw))
    assert "CRC mismatch" in msg


@pytest.mark.parametrize("kind", list(SIZES))
def test_missing_trailer_raises_as_the_reference(kind, native_on):
    plain = ifile.write_records(_records(kind))
    msg = _raised(ifile, StorageError, plain)
    assert msg == _raised(jifile, JStorageError, plain)
    assert "missing CRC" in msg
    # a trailer cut short is missing too
    cut = _write(ifile, _records(kind))[0][:-2]
    assert _raised(ifile, StorageError, cut) == _raised(
        jifile, JStorageError, cut)


def test_reference_crc_trailer_case_on_the_port():
    """``tests/test_ifile.py::test_crc_trailer`` as written, on the port."""
    out = io.BytesIO()
    w = ifile.IFileWriter(out, with_crc=True)
    w.append(b"k", b"v")
    w.close()
    raw = out.getvalue()
    assert raw.hex() == "01016b76ffff45832da9"
    assert int.from_bytes(raw[-4:], "big") == zlib.crc32(raw[:-4])
    assert ifile.crack(raw, verify_crc=True).num_records == 1
    flipped = bytearray(raw)
    flipped[2] ^= 1
    with pytest.raises(StorageError, match="CRC mismatch"):
        ifile.crack(bytes(flipped), verify_crc=True)
    with pytest.raises(StorageError, match="missing CRC"):
        ifile.crack(ifile.write_records([(b"k", b"v")]), verify_crc=True)
