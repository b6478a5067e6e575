"""Decode-once packed dataset cache (counterpart of
``simpleaicv_tpu/data/packed.py``): every sample's fields (the image on the
uint8 lattice at the training resolution, its labels) as fixed-stride
records in one file that is read through ``np.memmap``, written once by
``tools/prepare_dataset.py pack-*``. A training batch is then one gather
per field (``native_io.gather_records``, the GIL released) on a prefetch
thread: no per-sample Python and no decode.

Layout (version 1, byte for byte the JAX package's, so a pack written by
either package reads in the other)::

    [0 : 8192)                      header: magic + '\\n' + JSON, NUL-padded
    [field0_off : field0_off+size)  field 0, [N, *shape] C-contiguous
    [field1_off : ...)              field 1, ...

Each field starts at a multiple of 4096 bytes. The JSON header is
``{"version": 1, "num_samples": N, "fields": [{"name", "shape", "dtype",
"offset", "record_bytes"}...], "meta": {...}}`` in that key order.

* ``PackWriter`` / ``PackReader``: write and read the file;
* ``PackedDataset``: a per-sample view (the dataset protocol, for
  ``data.loader.DataLoader`` and any collater);
* ``PackedLoader``: the batch path, with ``DataLoader``'s protocol
  (``set_epoch``, ``len``, ``iter``): each epoch in the order
  ``RandomState(seed + epoch).permutation``, each process its contiguous
  share by the torch.distributed rank.

Against the JAX package: every field is gathered by the native library
(the JAX reader gathers fields under 64 KiB, and every field when the
library is absent, by numpy indexing), and ``pack_image_folder`` decodes
with the port's libjpeg binding only (the JAX one falls back to cv2).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import warnings
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.platform import process_count, process_index
from . import native_io
from .loader import rank_indices

__all__ = ["PackWriter", "PackReader", "PackedDataset", "PackedLoader",
           "pack_dataset", "pack_image_folder"]

_MAGIC = b"SAICVPACK1"
_HEADER_BYTES = 8192
_ALIGN = 4096


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class PackWriter:
    """Streaming writer. The fields (a fixed shape and dtype per sample) are
    declared up front; ``add`` writes a sample and ``close`` the header."""

    def __init__(self, path: str,
                 fields: Dict[str, Tuple[Sequence[int], str]],
                 num_samples: int, meta: Optional[dict] = None):
        self.path = path
        self.num_samples = int(num_samples)
        self._fields: List[dict] = []
        off = _HEADER_BYTES
        for name, (shape, dtype) in fields.items():
            dt = np.dtype(dtype)
            shape = tuple(int(s) for s in shape)
            size = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            self._fields.append({
                "name": name, "shape": list(shape), "dtype": dt.str,
                "offset": off, "record_bytes": size,
            })
            off = _align(off + size * self.num_samples)
        self.total_bytes = off
        self.meta = dict(meta or {})
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "wb")
        self._f.truncate(self.total_bytes)
        self._n = 0

    def add(self, sample: dict, index: Optional[int] = None):
        i = self._n if index is None else int(index)
        if not 0 <= i < self.num_samples:
            raise IndexError(f"sample {i} outside [0, {self.num_samples})")
        for fld in self._fields:
            arr = np.asarray(sample[fld["name"]], np.dtype(fld["dtype"]),
                             order="C")
            if arr.shape != tuple(fld["shape"]):
                raise ValueError(f"field {fld['name']!r}: shape {arr.shape}, "
                                 f"declared {tuple(fld['shape'])}")
            self._f.seek(fld["offset"] + i * fld["record_bytes"])
            self._f.write(arr.tobytes())
        if index is None:
            self._n += 1

    def close(self):
        header = _MAGIC + b"\n" + json.dumps({
            "version": 1,
            "num_samples": self.num_samples,
            "fields": self._fields,
            "meta": self.meta,
        }).encode()
        if len(header) >= _HEADER_BYTES:
            raise ValueError(f"pack header of {len(header)} bytes does not "
                             f"fit in {_HEADER_BYTES}")
        self._f.seek(0)
        self._f.write(header.ljust(_HEADER_BYTES, b"\0"))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PackReader:
    """``np.memmap`` view of a pack: ``arrays[name]`` is [N, *shape]; fields
    of at most 64 bytes a record (labels) are read into RAM.
    ``read_batch`` gathers a batch, one native gather per field."""

    def __init__(self, path: str, keep_in_ram: Optional[Sequence[str]] = None):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(_HEADER_BYTES)
        if head[:len(_MAGIC)] != _MAGIC:
            raise ValueError(f"not a pack file: {path}")
        info = json.loads(head[len(_MAGIC) + 1:].rstrip(b"\0").decode())
        if info["version"] != 1:
            raise ValueError(f"{path}: pack version {info['version']}, "
                             f"this reader reads 1")
        self.num_samples = info["num_samples"]
        self.meta = info.get("meta", {})
        self.fields = {f["name"]: f for f in info["fields"]}
        self.arrays: Dict[str, np.ndarray] = {}
        keep = set(keep_in_ram if keep_in_ram is not None
                   else self._small_fields())
        for f in info["fields"]:
            mm = np.memmap(path, np.dtype(f["dtype"]), mode="r",
                           offset=f["offset"],
                           shape=(self.num_samples, *f["shape"]))
            self.arrays[f["name"]] = np.array(mm) if f["name"] in keep else mm

    def _small_fields(self, thresh: int = 64) -> List[str]:
        return [n for n, f in self.fields.items()
                if f["record_bytes"] <= thresh]

    def __len__(self):
        return self.num_samples

    def read_batch(self, indices, n_threads: int = 1) -> Dict[str, np.ndarray]:
        idx = np.asarray(indices, np.int64)
        return {name: native_io.gather_records(arr, idx, n_threads=n_threads)
                for name, arr in self.arrays.items()}

    def read_sample(self, i: int) -> dict:
        s = {}
        for name, arr in self.arrays.items():
            v = np.array(arr[int(i)])
            s[name] = v.item() if v.ndim == 0 else v
        return s


class PackedDataset:
    """Per-sample dict view over a pack (images as f32 0..255, 0-d labels as
    Python numbers), with an optional per-sample ``transform``."""

    def __init__(self, path: str, transform=None):
        self.reader = PackReader(path)
        self.transform = transform
        self.class_names = self.reader.meta.get("class_names")

    def __len__(self):
        return len(self.reader)

    def __getitem__(self, i):
        s = self.reader.read_sample(i)
        if "image" in s:
            s["image"] = s["image"].astype(np.float32)
        if self.transform is not None:
            s = self.transform(s)
        return s


class PackedLoader:
    """Batches of a pack: one gather per field on a prefetch thread, then
    ``collate`` (a function of the gathered batch dict) if given. Images
    stay uint8 unless ``collate`` casts them. ``batch_size`` is the global
    batch; each process takes its share."""

    def __init__(self, source, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2,
                 n_threads: int = 1, collate=None,
                 accumulation_steps: int = 1):
        if isinstance(source, str):
            source = PackReader(source)
        elif isinstance(source, PackedDataset):
            source = source.reader
        self.reader: PackReader = source
        self.global_batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = max(int(prefetch), 1)
        self.n_threads = max(int(n_threads), 1)
        self.collate = collate
        self.accumulation_steps = max(int(accumulation_steps), 1)
        self.epoch = 0
        n_proc = process_count()
        if batch_size % n_proc:
            raise ValueError(f"batch {batch_size} does not split over "
                             f"{n_proc} processes")
        self.local_batch_size = batch_size // n_proc
        self._pid, self._nproc = process_index(), n_proc

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.reader) // self._nproc
        if self.drop_last:
            return n // self.local_batch_size
        return (n + self.local_batch_size - 1) // self.local_batch_size

    def _local_indices(self) -> np.ndarray:
        n = len(self.reader)
        if self.shuffle:
            order = np.random.RandomState(
                self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        return rank_indices(order, self._pid, self._nproc,
                            self.local_batch_size, self.accumulation_steps)

    def __iter__(self) -> Iterator[dict]:
        indices = self._local_indices()
        bs = self.local_batch_size
        n_batches = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(n_batches):
                    idx = indices[b * bs:min((b + 1) * bs, len(indices))]
                    batch = self.reader.read_batch(idx, self.n_threads)
                    if self.collate is not None:
                        batch = self.collate(batch)
                    if not put(batch):
                        return
            except Exception as e:  # noqa: BLE001 (raised in the consumer)
                put(e)
                return
            put(StopIteration)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is StopIteration:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)


def pack_dataset(dataset, out_path: str, image_dtype: str = "uint8",
                 extra_fields: Optional[Dict[str, Tuple[tuple, str]]] = None,
                 meta: Optional[dict] = None,
                 progress_every: int = 0) -> str:
    """Packs a per-sample dataset whose items are dicts of fixed-shape
    arrays; the fields come from sample 0 (non-numeric entries are left
    out), images on the uint8 lattice (rounded and clipped)."""
    n = len(dataset)
    s0 = dataset[0]
    fields: Dict[str, Tuple[tuple, str]] = {}
    for k, v in s0.items():
        arr = np.asarray(v)
        if not (np.issubdtype(arr.dtype, np.number)
                or np.issubdtype(arr.dtype, np.bool_)):
            continue
        if k == "image" and image_dtype == "uint8":
            fields[k] = (arr.shape, "uint8")
        elif arr.ndim == 0:
            fields[k] = ((), "int32" if np.issubdtype(arr.dtype, np.integer)
                         else "float32")
        else:
            fields[k] = (arr.shape, arr.dtype.str)
    if extra_fields:
        fields.update(extra_fields)
    with PackWriter(out_path, fields, n, meta=meta) as w:
        for i in range(n):
            s = dict(dataset[i])
            if "image" in fields and fields["image"][1] == "uint8":
                s["image"] = np.clip(np.round(
                    np.asarray(s["image"], np.float32)), 0, 255)
            w.add({k: s[k] for k in fields}, index=i)
            if progress_every and (i + 1) % progress_every == 0:
                print(f"packed {i + 1}/{n}")
    return out_path


def pack_image_folder(root: str, out_path: str, image_hw: int = 224,
                      letterbox: bool = False, batch: int = 256,
                      n_threads: int = 0,
                      progress_every: int = 10000) -> str:
    """Packs an ImageFolder layout (one sub-folder per class, class ids in
    sorted order, the ILSVRC2012 layout) into uint8 records at
    ``image_hw``, decoding with the threaded libjpeg path. A file that does
    not decode leaves a zero record, counted in ``meta["decode_failures"]``
    with a warning."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        for fname in sorted(os.listdir(cdir)):
            paths.append(os.path.join(cdir, fname))
            labels.append(ci)
    n = len(paths)
    fields = {"image": ((image_hw, image_hw, 3), "uint8"),
              "label": ((), "int32")}
    meta = {"class_names": classes, "source_root": os.path.abspath(root),
            "image_hw": image_hw, "letterbox": bool(letterbox)}
    n_failed = 0
    with PackWriter(out_path, fields, n, meta=meta) as w:
        for b0 in range(0, n, batch):
            chunk = paths[b0:b0 + batch]
            imgs, ok = native_io.batch_decode_files_u8(
                chunk, image_hw, n_threads=n_threads, letterbox=letterbox,
                return_ok=True)
            n_failed += len(chunk) - ok
            for j in range(len(chunk)):
                w.add({"image": imgs[j],
                       "label": np.int32(labels[b0 + j])}, index=b0 + j)
            if progress_every and (b0 + len(chunk)) % progress_every < batch:
                print(f"packed {b0 + len(chunk)}/{n}")
        w.meta["decode_failures"] = int(n_failed)
    if n_failed:
        warnings.warn(f"pack_image_folder: {n_failed}/{n} images failed to "
                      f"decode; their records are zero-filled "
                      f"(meta['decode_failures'])", stacklevel=2)
    return out_path
