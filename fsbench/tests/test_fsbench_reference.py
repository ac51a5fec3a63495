"""The plain reference against bytes and part-file names worked out by hand."""

import numpy as np

from fsbench import reference as ref


def test_expected_bytes():
    pool = np.arange(40, dtype=np.uint8)
    # file 2 of 10-byte files holds pool[20:30]; a read past its end is short
    assert ref.expected(pool, 10, 2, 3, 4).tolist() == [23, 24, 25, 26]
    assert ref.expected(pool, 10, 2, 8, 5).tolist() == [28, 29]


def test_chunk_format():
    assert ref.CHUNK == 64 << 20 and ref.BLOCK == 64 << 10
    # ec(8,4): slice type 10 + 32 * (8 - 2) + (4 - 1); its last parity part is index 11
    assert ref.ec_part((10 + 32 * 6 + 3) * 64 + 11) == 11
    assert ref.part_path("/d", 0x1234, 0x35C4, 3) == \
        "/d/34/chunk_0000000000001234_P000035C4_00000003.liz"
