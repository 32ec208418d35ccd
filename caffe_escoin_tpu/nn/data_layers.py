"""IO-backed data layers: Data (.cerec), MemoryData, ImageData, HDF5Data,
HDF5Output, WindowData.

Reference: `src/caffe/layers/{data,memory_data,image_data,hdf5_data,
hdf5_output,window_data}_layer.cpp`. In the reference these are ordinary
layers whose Forward pops a prefetched batch from a background thread
(`BasePrefetchingDataLayer`, base_data_layer.hpp:52-78). Here they are the
same: host-side IO layers that produce numpy/jnp batches at apply() time.

They are *eager* layers — host IO cannot live under jit. The idiomatic
path for production input is `data.pipeline.PrefetchLoader` feeding `Input`
blobs of a jitted Net.apply; these layers exist for API parity (small jobs,
tests, tooling like `compute_image_mean`) and reuse the same PrefetchLoader
underneath, so the double-buffering behavior matches the reference.
"""

from __future__ import annotations

import os
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from caffe_escoin_tpu.data.datasets import cerec_source, read_cerec_header
from caffe_escoin_tpu.data.pipeline import PrefetchLoader
from caffe_escoin_tpu.data.transformer import DataTransformer, TransformParams
from caffe_escoin_tpu.nn.net import Layer, register_layer


def _make_transformer(p, phase):
    tp = p.get("transform_param")
    if not tp:
        return None
    params = TransformParams(
        crop_size=tp.get("crop_size", 0),
        mirror=tp.get("mirror", False),
        scale=tp.get("scale", 1.0),
        mean_value=tuple(tp["mean_value"]) if tp.get("mean_value") else None,
        phase=phase,
    )
    if tp.get("mean_file"):
        params.mean_image = np.load(tp["mean_file"]).astype(np.float32)
    return DataTransformer(params, seed=tp.get("seed", 0))


class _PrefetchingDataLayer(Layer):
    """Shared base: lazy PrefetchLoader construction + batch pop on apply.

    Mirrors BasePrefetchingDataLayer: source callable runs on a background
    thread, transformer applied there too (data_transformer inside
    InternalThreadEntry), apply() = pop from the full queue."""

    category = "data"
    tops_from_batch = ("data", "label")

    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        self._loader: Optional[PrefetchLoader] = None

    def _source(self):  # -> callable yielding {"data": ..., "label": ...}
        raise NotImplementedError

    def _phase(self):
        return self.p.get("phase", "train")

    def apply(self, params, inputs, *, train, rng):
        if self._loader is None:
            self._loader = PrefetchLoader(
                self._source(),
                transform=_make_transformer(self.p, self._phase()),
                device_put=False,
            )
        batch = next(self._loader)
        out = [jnp.asarray(batch[k]) for k in self.tops_from_batch
               if k in batch]
        return out

    def close(self):
        if self._loader is not None:
            self._loader.close()
            self._loader = None


@register_layer("Data")
class DataLayer(_PrefetchingDataLayer):
    """Record-database-backed data layer (data_layer.cpp). Backends:
    `.cerec` (this framework's native record database, data/datasets.py +
    csrc/recordio.cc) and the reference's own LMDB databases
    (`src/caffe/util/db_lmdb.cpp`), read in place by the dependency-free
    B+tree walker in data/lmdb_io.py (Datum records, `backend: "lmdb"` in
    prototxt `data_param` or a `.mdb`/`data.mdb` source path). Same role
    either way: a sequential record cursor feeding the prefetch thread."""

    def _is_lmdb(self):
        src = self.p["source"]
        if str(self.p.get("backend", "")).lower() in ("lmdb", "1"):
            return True
        return (src.endswith(".mdb")
                or os.path.exists(os.path.join(src, "data.mdb")))

    def _source(self):
        if self._is_lmdb():
            from caffe_escoin_tpu.data.lmdb_io import lmdb_source

            return lmdb_source(self.p["source"], self.p["batch_size"])
        return cerec_source(self.p["source"], self.p["batch_size"])

    def out_shapes(self, params, in_shapes):
        n = self.p["batch_size"]
        if self._is_lmdb():
            from caffe_escoin_tpu.data.lmdb_io import (LmdbReader,
                                                       datum_decode)

            k, v = next(LmdbReader(self.p["source"]).items())
            h, w, c = datum_decode(v)[0].shape
        else:
            header = read_cerec_header(self.p["source"])
            h, w, c = header["sample_shape"]
        cs = (self.p.get("transform_param") or {}).get("crop_size", 0)
        if cs:
            h = w = cs
        return [(n, h, w, c), (n,)]


@register_layer("MemoryData")
class MemoryDataLayer(_PrefetchingDataLayer):
    """In-memory dataset (memory_data_layer.cpp). `reset(data, labels)` is
    the MemoryDataLayer::Reset analogue; batches cycle through the arrays."""

    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        self._data = None
        self._labels = None
        self._pos = 0

    def reset(self, data, labels):
        data = np.asarray(data, np.float32)
        labels = np.asarray(labels, np.float32)
        n = self.p["batch_size"]
        if len(data) % n != 0:
            raise ValueError(  # memory_data_layer.cpp:80 CHECK
                f"data size {len(data)} not divisible by batch_size {n}")
        self._data, self._labels, self._pos = data, labels, 0
        self.close()  # invalidate any running loader

    def _source(self):
        if self._data is None:
            raise RuntimeError("MemoryData: call reset(data, labels) first")
        n = self.p["batch_size"]

        def src():
            i = self._pos
            self._pos = (i + n) % len(self._data)
            return {"data": self._data[i:i + n],
                    "label": self._labels[i:i + n]}

        return src

    def out_shapes(self, params, in_shapes):
        n = self.p["batch_size"]
        return [(n, self.p["height"], self.p["width"], self.p["channels"]),
                (n,)]


def _load_image(path, *, color=True, new_height=0, new_width=0):
    from PIL import Image

    img = Image.open(path)
    img = img.convert("RGB" if color else "L")
    if new_height and new_width:
        img = img.resize((new_width, new_height), Image.BILINEAR)
    arr = np.asarray(img, np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


@register_layer("ImageData")
class ImageDataLayer(_PrefetchingDataLayer):
    """Image-list data layer (image_data_layer.cpp): `source` is a text file
    of "<path> <label>" lines; images decoded (PIL instead of OpenCV) and
    resized to new_height x new_width on the prefetch thread."""

    def _lines(self):
        root = self.p.get("root_folder", "")
        with open(self.p["source"]) as f:
            entries = [ln.split() for ln in f if ln.strip()]
        return [(os.path.join(root, p), float(l)) for p, l in entries]

    def _source(self):
        entries = self._lines()
        if self.p.get("shuffle", False):
            rng = np.random.default_rng(self.p.get("seed", 0))
            rng.shuffle(entries)
        n = self.p["batch_size"]
        pos = [0]

        def src():
            imgs, labels = [], []
            for _ in range(n):
                path, label = entries[pos[0] % len(entries)]
                pos[0] += 1
                imgs.append(_load_image(
                    path, color=self.p.get("is_color", True),
                    new_height=self.p.get("new_height", 0),
                    new_width=self.p.get("new_width", 0)))
                labels.append(label)
            return {"data": np.stack(imgs),
                    "label": np.asarray(labels, np.float32)}

        return src

    def out_shapes(self, params, in_shapes):
        n = self.p["batch_size"]
        first = self._lines()[0][0]
        img = _load_image(first, color=self.p.get("is_color", True),
                          new_height=self.p.get("new_height", 0),
                          new_width=self.p.get("new_width", 0))
        h, w, c = img.shape
        cs = (self.p.get("transform_param") or {}).get("crop_size", 0)
        if cs:
            h = w = cs
        return [(n, h, w, c), (n,)]


@register_layer("HDF5Data")
class HDF5DataLayer(_PrefetchingDataLayer):
    """HDF5 data layer (hdf5_data_layer.cpp): `source` lists .h5 files, each
    holding equally-sized datasets; every named dataset becomes a top, in the
    order given by `tops` (defaults to the spec's declared tops).

    Streams ONE file into memory at a time (`hdf5_data_layer.cpp:27,111,142`
    LoadHDF5FileData on rollover); batches span file boundaries. With
    `shuffle`, both the file order and the rows within each file are permuted
    per epoch (the reference's file_permutation_/data_permutation_)."""

    def _source(self):
        import h5py

        with open(self.p["source"]) as f:
            files = [ln.strip() for ln in f if ln.strip()]
        tops = list(self.spec.tops)
        n = self.p["batch_size"]
        shuffle = self.p.get("shuffle", False)
        rng = np.random.default_rng(self.p.get("seed", 0))
        file_order = list(range(len(files)))
        if shuffle:  # first epoch too (hdf5_data_layer.cpp LayerSetUp)
            rng.shuffle(file_order)
        state = {"fi": 0, "pos": 0, "cur": None, "order": None}

        def _load_current():
            path = files[file_order[state["fi"]]]
            with h5py.File(path, "r") as h5:
                state["cur"] = {t: np.asarray(h5[t], np.float32)
                                for t in tops}
            order = np.arange(len(state["cur"][tops[0]]))
            if shuffle:
                rng.shuffle(order)
            state["order"], state["pos"] = order, 0

        def src():
            out = {t: [] for t in tops}
            need = n
            while need > 0:
                if state["cur"] is None:
                    _load_current()
                avail = len(state["order"]) - state["pos"]
                take = min(need, avail)
                idx = state["order"][state["pos"]:state["pos"] + take]
                for t in tops:
                    out[t].append(state["cur"][t][idx])
                state["pos"] += take
                need -= take
                if state["pos"] >= len(state["order"]):
                    state["cur"] = None  # free this file before the next
                    state["fi"] += 1
                    if state["fi"] >= len(files):  # epoch rollover
                        state["fi"] = 0
                        if shuffle:
                            rng.shuffle(file_order)
            return {t: np.concatenate(out[t]) if len(out[t]) > 1
                    else out[t][0] for t in tops}

        return src

    @property
    def tops_from_batch(self):
        return tuple(self.spec.tops)

    def out_shapes(self, params, in_shapes):
        import h5py

        with open(self.p["source"]) as f:
            first = next(ln.strip() for ln in f if ln.strip())
        n = self.p["batch_size"]
        shapes = []
        with h5py.File(first, "r") as h5:
            for t in self.spec.tops:
                shapes.append((n,) + tuple(h5[t].shape[1:]))
        return shapes


@register_layer("HDF5Output")
class HDF5OutputLayer(Layer):
    """Writes its bottoms to an HDF5 file (hdf5_output_layer.cpp): datasets
    "data" and "label", appended across forward calls; `flush()` (or close)
    finalizes the file."""

    category = "data"

    def __init__(self, spec, policy):
        super().__init__(spec, policy)
        self._chunks: List[List[np.ndarray]] = []

    def apply(self, params, inputs, *, train, rng):
        self._chunks.append([np.asarray(b) for b in inputs])
        return []

    def flush(self):
        import h5py

        names = ["data", "label", "top2", "top3"]
        with h5py.File(self.p["file_name"], "w") as h5:
            if self._chunks:
                for i in range(len(self._chunks[0])):
                    h5.create_dataset(
                        names[i],
                        data=np.concatenate([c[i] for c in self._chunks]))
        self._chunks = []

    def out_shapes(self, params, in_shapes):
        return []


@register_layer("WindowData")
class WindowDataLayer(_PrefetchingDataLayer):
    """R-CNN window sampling (window_data_layer.cpp): `source` is the R-CNN
    window file format —

        # <image_index>
        <image_path>
        <channels> <height> <width>
        <num_windows>
        <class_index> <overlap> <x1> <y1> <x2> <y2>
        ...

    Each batch draws fg_fraction foreground windows (overlap >=
    fg_threshold) and the rest background (overlap < bg_threshold, class 0),
    crops each window with `context_pad`, and warps it to crop_size x
    crop_size (the reference's cv::resize warp)."""

    def _parse(self):
        images, windows = [], []
        with open(self.p["source"]) as f:
            lines = [ln.rstrip("\n") for ln in f]
        i = 0
        while i < len(lines):
            if not lines[i].startswith("#"):
                i += 1
                continue
            path = lines[i + 1].strip()
            num = int(lines[i + 3])
            img_id = len(images)
            images.append(path)
            for j in range(num):
                cls, ov, x1, y1, x2, y2 = lines[i + 4 + j].split()
                windows.append((img_id, int(cls), float(ov), int(x1),
                                int(y1), int(x2), int(y2)))
            i += 4 + num
        return images, windows

    def _source(self):
        from PIL import Image

        images, windows = self._parse()
        fg_thr = self.p.get("fg_threshold", 0.5)
        bg_thr = self.p.get("bg_threshold", 0.5)
        fg = [w for w in windows if w[2] >= fg_thr]
        bg = [w for w in windows if w[2] < bg_thr]
        n = self.p["batch_size"]
        n_fg = int(round(n * self.p.get("fg_fraction", 0.25)))
        cs = self.p.get("crop_size", 227)
        pad = self.p.get("context_pad", 0)
        rng = np.random.default_rng(self.p.get("seed", 0))
        cache = {}

        def crop(win):
            img_id, cls, _, x1, y1, x2, y2 = win
            if img_id not in cache:
                cache[img_id] = Image.open(images[img_id]).convert("RGB")
            img = cache[img_id]
            box = (max(0, x1 - pad), max(0, y1 - pad),
                   min(img.width, x2 + pad), min(img.height, y2 + pad))
            patch = img.crop(box).resize((cs, cs), Image.BILINEAR)
            return np.asarray(patch, np.float32), float(cls)

        def src():
            picks = ([fg[rng.integers(len(fg))] for _ in range(n_fg)]
                     if fg else [])
            picks += [bg[rng.integers(len(bg))]
                      for _ in range(n - len(picks))] if bg else []
            while len(picks) < n:  # degenerate files: repeat fg
                picks.append(fg[rng.integers(len(fg))])
            data, labels = zip(*[crop(w) for w in picks])
            # background windows are class 0 regardless of stored class
            labels = [0.0 if w[2] < fg_thr else l
                      for w, l in zip(picks, labels)]
            return {"data": np.stack(data),
                    "label": np.asarray(labels, np.float32)}

        return src

    def out_shapes(self, params, in_shapes):
        n = self.p["batch_size"]
        cs = self.p.get("crop_size", 227)
        return [(n, cs, cs, 3), (n,)]
