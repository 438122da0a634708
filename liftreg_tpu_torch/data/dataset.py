"""2D/3D registration datasets and the host input pipeline, PyTorch port of
``liftreg_tpu/data/dataset.py`` (numpy on the host; the port imports
nothing of the JAX package, so it keeps its own copy).

Per-phase case lists from ``{phase}/data_id.npy`` (debug == train), the
SAR->SPR flip of the volumes, HU clip [-1000, 0] -> [-1, 1], DRR clip
[0, 6] -> [-1, 1] subsampled by ``load_projection_interval``, shared
``poses.npy`` and an optional per-view ROI. The splits are read into host
RAM by a thread pool; :class:`DataLoader` batches them with a prefetch
thread and shuffles with ``np.random.default_rng(seed)`` as the JAX loader
does, so the order of the batches is the same. :class:`DeviceDatasetCache`
and :class:`DeviceDataLoader` keep a whole split on the card and gather
each batch there. :func:`pad_batch` is the JAX package's
``parallel/mesh.py`` padding of a short batch, without the sharding.
Both loaders take ``pad_to`` and ``shard=(rank, ranks)``: every rank of
a data mesh draws the same order (one seed), pads each batch by index to
``pad_to`` rows, as the JAX trainer pads to a multiple of its mesh, and
loads only its own rows ``[rank * b, (rank + 1) * b)``, ``b = pad_to /
ranks``; ``names`` lists the real samples of the whole batch.
``compress_in_memory`` keeps each case packed by the native codec
(:mod:`..native`, the JAX codec's format) and unpacks it as it is read.
"""
from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from .. import native
from ..device import resolve_device


def normalize_intensity(img, linear_clip=False, clip_range=None):
    """[-1,1] normalization (``Registration2D3DDataset.py:186-209``)."""
    img = np.asarray(img, dtype=np.float32)
    if linear_clip:
        if clip_range is not None:
            img = np.clip(img, clip_range[0], clip_range[1])
            out = (img - clip_range[0]) / (clip_range[1] - clip_range[0])
        else:
            img = img - img.min()
            out = img / np.percentile(img, 95) * 0.95
    else:
        out = (img - img.min()) / (img.max() - img.min())
    return out * 2.0 - 1.0


def _opt_get(option, key, default):
    if option is None:
        return default
    try:
        if isinstance(option, dict):
            return option.get(key, default)
        return option[(key, default)]
    except Exception:  # noqa: BLE001
        return default


class Registration2D3DDataset:
    """In-RAM dataset of (CT pair, projections, poses) samples."""

    #: normalization mode: 'hu_clip' ([-1000,0]) or 'percentile'
    use_atten_source = False

    def __init__(self, data_path, phase=None, transform=None, option=None):
        phase_for_ids = "train" if phase == "debug" else phase
        self.data_id_path = os.path.join(data_path, phase_for_ids, "data_id.npy")
        self.data_path = os.path.join(data_path, "preprocessed")
        drr_name = _opt_get(option, "drr_folder_name", "drr")
        self.drr_path = os.path.join(data_path, "drr", str(drr_name), "drr")
        self.roi_path = os.path.join(data_path, "drr", str(drr_name), "roi")
        if not os.path.exists(self.roi_path):
            self.roi_path = ""
        self.phase = phase
        self.transform = transform

        ind = ["train", "val", "test", "debug"].index(phase)
        max_num = _opt_get(option, "max_num_for_loading", (-1, -1, -1, -1))[ind]
        self.has_label = bool(_opt_get(option, "use_segmentation_map", False))
        self.spacing = np.asarray(_opt_get(option, "spacing_to_refer", (1, 1, 1)),
                                  dtype=np.float32)
        self.interval = int(_opt_get(option, "load_projection_interval", 2))
        self.apply_hu_clip = bool(_opt_get(option, "apply_hu_clip", False))
        # the native codec's in-RAM compression of every case
        # (:mod:`..native`), unpacked as each sample is read
        self.compress = bool(_opt_get(option, "compress_in_memory", False))

        if os.path.exists(self.data_id_path):
            names = [str(n) for n in np.load(self.data_id_path)]
        else:
            names = []
        if max_num > 0:
            names = names[:max_num]
        self.name_list = names
        self.cases: List[Dict[str, np.ndarray]] = []
        self._load_all()

    # -- loading ------------------------------------------------------------
    def _normalize_ct(self, vol):
        if self.apply_hu_clip:
            return normalize_intensity(vol, linear_clip=True,
                                       clip_range=(-1000, 0))
        return normalize_intensity(vol, linear_clip=True)

    def _read_case(self, case_id):
        case = {}
        src = np.flip(np.load(os.path.join(
            self.data_path, case_id + "_source.npy")).astype(np.float32), axis=1)
        tgt = np.flip(np.load(os.path.join(
            self.data_path, case_id + "_target.npy")).astype(np.float32), axis=1)
        if self.use_atten_source:
            # projection-loss variant keeps an attenuation copy of the source
            # (``Registration2D3DForProjLossDataset.py:83,250-253``)
            case["original_source"] = np.maximum(src, -1000.0)
            case["original_source"] = ((case["original_source"] + 1000.0)
                                       / 1000.0 * 0.2).astype(np.float32)
        case["source"] = self._normalize_ct(src)
        case["target"] = self._normalize_ct(tgt)
        if self.has_label:
            case["source_label"] = np.flip(np.load(os.path.join(
                self.data_path, case_id + "_source_seg.npy")).astype(np.float32),
                axis=1).copy()
            case["target_label"] = np.flip(np.load(os.path.join(
                self.data_path, case_id + "_target_seg.npy")).astype(np.float32),
                axis=1).copy()
        for side in ("source", "target"):
            proj = np.load(os.path.join(
                self.drr_path, f"{case_id}_{side}_proj.npy")).astype(np.float32)
            proj = normalize_intensity(proj, linear_clip=True,
                                       clip_range=(0, 6))[::self.interval]
            case[side + "_proj"] = np.ascontiguousarray(proj)
        if self.roi_path:
            roi = np.load(os.path.join(
                self.roi_path, f"{case_id}_target_proj_roi.npy"))[::self.interval]
            case["target_proj_roi"] = roi.astype(np.int32)
        case["target_poses"] = np.load(os.path.join(
            self.drr_path, "poses.npy")).astype(np.float32)[::self.interval]
        case["spacing"] = self.spacing.copy()
        if self.compress:
            case = {k: native.pack_array(v) for k, v in case.items()}
        return case

    def _load_all(self):
        if not self.name_list:
            return
        with ThreadPoolExecutor(max_workers=min(12, len(self.name_list))) as ex:
            self.cases = list(ex.map(self._read_case, self.name_list))
        print(f"the loading phase {self.phase} finished, total "
              f"{len(self.cases)} img and labels have been loaded")

    # -- access -------------------------------------------------------------
    def __len__(self):
        return len(self.name_list)

    def __getitem__(self, idx):
        idx = idx % len(self.name_list)
        case = self.cases[idx]
        if self.compress:
            case = {k: native.unpack_array(*v) for k, v in case.items()}
        sample = {
            "source": case["source"][None],
            "target": case["target"][None],
            "target_proj": case["target_proj"],
            "source_proj": case["source_proj"],
            "target_poses": case["target_poses"],
            "spacing": case["spacing"],
        }
        if self.has_label:
            sample["source_label"] = case["source_label"][None]
            sample["target_label"] = case["target_label"][None]
        if "target_proj_roi" in case:
            sample["target_proj_roi"] = case["target_proj_roi"]
        if "original_source" in case:
            sample["original_source"] = case["original_source"][None]
        return sample, self.name_list[idx]


class Registration2D3DForProjLossDataset(Registration2D3DDataset):
    """Variant carrying an attenuation-coefficient source volume for
    reprojection losses, with percentile normalization
    (``Registration2D3DForProjLossDataset.py``)."""
    use_atten_source = True

    def _normalize_ct(self, vol):
        return normalize_intensity(vol, linear_clip=True)


DATASET_REGISTRY = {
    "registration2d3d": Registration2D3DDataset,
    "registration2d3d_projloss": Registration2D3DForProjLossDataset,
    "liftreg.dataset.Registration2D3DDataset.Registration2D3DDataset":
        Registration2D3DDataset,
    "liftreg.dataset.Registration2D3DForProjLossDataset.Registration2D3DDataset":
        Registration2D3DForProjLossDataset,
}


def get_dataset(name):
    if name in DATASET_REGISTRY:
        return DATASET_REGISTRY[name]
    raise KeyError(f"unknown dataset '{name}'; known: {sorted(DATASET_REGISTRY)}")


def _stack_batch(samples):
    keys = samples[0][0].keys()
    batch = {k: np.stack([s[0][k] for s in samples]) for k in keys}
    names = [s[1] for s in samples]
    return batch, names


class DeviceDatasetCache:
    """A whole split on the card: every sample's arrays stacked into one
    device tensor per key, once, so that a batch is one gather per key
    (``index_select``) with no copy from the host per step. ``device``
    None means the CUDA card."""

    def __init__(self, dataset, device=None):
        device = resolve_device(device)
        samples, names = [], []
        for i in range(len(dataset)):
            s, n = dataset[i]
            samples.append(s)
            names.append(n)
        if not samples:
            raise ValueError("empty dataset")
        self.names = names
        self.device = device
        self.arrays = {
            k: torch.from_numpy(np.stack([s[k] for s in samples])).to(device)
            for k in samples[0].keys()
        }
        self.nbytes = sum(v.numel() * v.element_size()
                          for v in self.arrays.values())

    def __len__(self):
        return len(self.names)

    def gather(self, indices):
        """Assemble a batch on the card; indices may repeat (padding)."""
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64)).to(
            self.device)
        return {k: v.index_select(0, idx) for k, v in self.arrays.items()}


def _batches(n, batch_size, shuffle, drop_last, rng):
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    batches = [idx[i:i + batch_size] for i in range(0, n, batch_size)]
    if drop_last:
        batches = [b for b in batches if len(b) == batch_size]
    return batches


def _rows(b, pad_to, shard):
    """This rank's indices of batch ``b`` padded to ``pad_to`` by its last
    index (``pad_to`` None: ``b`` as it is)."""
    if pad_to is None:
        return b
    full = np.concatenate([b, np.repeat(b[-1:], pad_to - len(b))]) \
        if len(b) < pad_to else b
    rank, ranks = shard
    n = pad_to // ranks
    return full[rank * n:(rank + 1) * n]


def _check_shard(batch_size, pad_to, shard):
    rank, ranks = shard
    if ranks > 1 and (pad_to is None or pad_to % ranks):
        raise ValueError(f"pad_to {pad_to} must be a multiple of the "
                         f"{ranks} ranks")
    if pad_to is not None and pad_to < batch_size:
        raise ValueError(f"pad_to {pad_to} < batch_size {batch_size}")
    if not 0 <= rank < ranks:
        raise ValueError(f"rank {rank} of {ranks}")


class DeviceDataLoader:
    """Loader over a :class:`DeviceDatasetCache` with the semantics of
    :class:`DataLoader` (shuffle / drop_last), plus padding by index:
    every batch has exactly ``pad_to`` rows (a short final batch repeats
    its last index) while ``names`` lists only the real samples. With
    ``shard`` a rank gathers its rows of each batch; the cache holds the
    whole split all the same, since the shuffled order puts any sample in
    any rank's rows."""

    def __init__(self, cache, batch_size=1, shuffle=False, seed=0,
                 drop_last=False, pad_to=None, shard=(0, 1)):
        self.cache = cache
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_to = pad_to or batch_size
        self.shard = tuple(shard)
        _check_shard(batch_size, self.pad_to, self.shard)
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.cache)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        for b in _batches(len(self.cache), self.batch_size, self.shuffle,
                          self.drop_last, self._rng):
            names = [self.cache.names[int(i)] for i in b]
            yield self.cache.gather(_rows(b, self.pad_to, self.shard)), names


class DataLoader:
    """Minimal batching loader with shuffling and background prefetch; with
    ``pad_to`` each batch is padded by index to that many rows, and with
    ``shard`` a rank stacks only its rows of it."""

    def __init__(self, dataset, batch_size=1, shuffle=False, seed=0,
                 drop_last=False, prefetch=2, pad_to=None, shard=(0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.pad_to = pad_to
        self.shard = tuple(shard)
        _check_shard(batch_size, pad_to, self.shard)
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        batches = _batches(len(self.dataset), self.batch_size, self.shuffle,
                           self.drop_last, self._rng)

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            for b in batches:
                batch, _ = _stack_batch([
                    self.dataset[int(i)]
                    for i in _rows(b, self.pad_to, self.shard)])
                q.put((batch, [self.dataset.name_list[int(i)] for i in b]))
            q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item


def pad_batch(batch: dict, target_b: int):
    """Pad every array's batch axis (axis 0) up to ``target_b`` by
    repeating the final sample, so that every batch has the same shape.
    Numpy arrays and tensors (on any device) are padded in kind; other
    entries pass through.

    Returns ``(padded_batch, n_valid)``; callers must ignore rows
    ``[n_valid:]`` in any per-sample output."""
    b = next(v.shape[0] for v in batch.values()
             if hasattr(v, "ndim") and v.ndim > 0)
    if target_b < b:
        raise ValueError(f"pad target {target_b} < batch size {b}")
    if target_b == b:
        return batch, b
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and v.dim() > 0:
            out[k] = torch.cat([v, v[-1:].expand(target_b - b,
                                                 *v.shape[1:])])
        elif hasattr(v, "ndim") and v.ndim > 0:
            pad = np.repeat(np.asarray(v)[-1:], target_b - b, axis=0)
            out[k] = np.concatenate([np.asarray(v), pad], axis=0)
        else:
            out[k] = v
    return out, b
