"""Dependency-free LMDB read/write (data/lmdb_io.py): the reference's
`db_lmdb` ingestion path (`src/caffe/util/db_lmdb.cpp:1-113`), readable
without liblmdb. Round-trip validation plus structural checks (multi-leaf
B+tree, overflow values, meta selection) and the Datum codec."""

import numpy as np
import pytest

from caffe_escoin_tpu.data import lmdb_io


def _mk(tmp_path, items, psize=4096):
    p = str(tmp_path / "db")
    import os
    os.makedirs(p, exist_ok=True)
    lmdb_io.write_lmdb(p, items, psize=psize)
    return p


def test_roundtrip_small(tmp_path):
    items = [(b"%08d" % i, b"value-%d" % i) for i in range(10)]
    p = _mk(tmp_path, items)
    rd = lmdb_io.LmdbReader(p)
    assert len(rd) == 10
    got = list(rd.items())
    assert got == sorted(items)


def test_roundtrip_multi_leaf_and_overflow(tmp_path):
    rng = np.random.default_rng(0)
    items = []
    for i in range(200):  # forces several leaf pages
        items.append((b"%08d" % i, rng.bytes(40)))
    items.append((b"big-0001", rng.bytes(9000)))   # overflow run
    items.append((b"big-0002", rng.bytes(5000)))
    p = _mk(tmp_path, items)
    rd = lmdb_io.LmdbReader(p)
    assert len(rd) == len(items)
    got = dict(rd.items())
    for k, v in items:
        assert got[k] == v, k
    assert list(got) == sorted(got)  # key order


def test_psize_probe(tmp_path):
    items = [(b"a", b"1"), (b"b", b"2")]
    p = _mk(tmp_path, items, psize=8192)
    rd = lmdb_io.LmdbReader(p)
    assert rd.psize == 8192
    assert dict(rd.items()) == dict(items)


def test_datum_codec_uint8_and_float():
    rng = np.random.default_rng(1)
    img8 = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    raw = lmdb_io.datum_encode(img8, label=7)
    arr, label = lmdb_io.datum_decode(raw)
    assert label == 7
    np.testing.assert_array_equal(arr, img8)
    imgf = rng.standard_normal((4, 4, 1)).astype(np.float32)
    arr2, label2 = lmdb_io.datum_decode(lmdb_io.datum_encode(imgf, label=2))
    assert label2 == 2
    np.testing.assert_allclose(arr2, imgf, rtol=1e-6)


def test_lmdb_source_batches(tmp_path):
    rng = np.random.default_rng(2)
    items = []
    for i in range(7):
        img = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        items.append((b"%08d" % i, lmdb_io.datum_encode(img, label=i % 3)))
    p = _mk(tmp_path, items)
    src = lmdb_io.lmdb_source(p, batch=4)
    b1 = src()
    assert b1["data"].shape == (4, 8, 8, 3)
    assert b1["label"].tolist() == [0, 1, 2, 0]
    b2 = src()  # wraps the cursor (reference DataLayer semantics)
    assert b2["data"].shape == (4, 8, 8, 3)
    assert b2["label"].tolist() == [1, 2, 0, 0]


def test_rejects_non_lmdb(tmp_path):
    f = tmp_path / "x.mdb"
    f.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="magic|not an LMDB"):
        lmdb_io.LmdbReader(str(f))


def test_data_layer_reads_lmdb(tmp_path):
    """The Data layer consumes a reference-style LMDB in place
    (`db_lmdb.cpp` databases)."""
    from caffe_escoin_tpu.engine.context import ExecutionPolicy
    from caffe_escoin_tpu.nn import LayerSpec
    from caffe_escoin_tpu.nn.net import LAYER_REGISTRY

    rng = np.random.default_rng(3)
    p = str(tmp_path / "db")
    import os
    os.makedirs(p)
    items = []
    for i in range(6):
        img = rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)
        items.append((b"%08d" % i, lmdb_io.datum_encode(img, label=i)))
    lmdb_io.write_lmdb(p, items)

    spec = LayerSpec(name="d", type="Data", bottoms=[],
                     tops=["data", "label"],
                     params=dict(source=p, batch_size=3))
    layer = LAYER_REGISTRY["Data"](spec, ExecutionPolicy())
    assert layer.out_shapes({}, []) == [(3, 6, 6, 3), (3,)]
    d, l = layer.apply({}, [], train=True, rng=None)
    assert d.shape == (3, 6, 6, 3)
    d2, l2 = layer.apply({}, [], train=True, rng=None)
    got = np.sort(np.concatenate([np.asarray(l), np.asarray(l2)]))
    np.testing.assert_array_equal(got, np.arange(6))
    layer.close()
