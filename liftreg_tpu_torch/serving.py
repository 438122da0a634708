"""One-file serving artifacts: the amortized registration program and its
weights, PyTorch port of ``liftreg_tpu/serving.py``.

A user exports a trained pipeline once (:func:`export_serving`) and
serves from one file (:class:`ServingModel`). The program is a
``torch.export`` program of :meth:`.pipeline.RegistrationPipeline.predict`
(or ``predict_projections``, the CT-free entry) at a fixed batch: HU clip
-> DRR (``liftreg::project``) -> the encoder's input with its lift
(``liftreg::encoder_input``) -> encoder -> PCA expansion
(``liftreg::pca_expand``) -> warp (``liftreg::warp_trilinear``). Its
kernels are ``torch.library`` operators (:mod:`.ops._library`), so the
program calls them by name and runs them on whatever device it is given.
The weights, the PCA basis and the pipeline's constant tensors (poses,
DRR geometry, identity map) are the program's inputs, not its constants:
they are stored once, in the file's array sections, and the program's
bytes hold only code.

Refinement is not in the program: the port's refiner differentiates with
autograd and stops early on a host read, which ``torch.export`` captures
neither of. An artifact with ``refine_steps > 0`` exports a program that
also returns the encoder's coefficients, the masked moving CT and what the
refinement compares with; :class:`ServingModel` rebuilds the port's
refiner from the settings in ``meta`` and runs it on them, as
``RegistrationPipeline.register`` does (:func:`.pipeline.refine_tail`).

Two formats, sniffed by magic on load, with the JAX package's byte layout
(its ``read_artifact`` reads the port's files, and :func:`read_artifact`
reads the JAX package's):

* **version 2 (default): zero-copy sections.** ``b"LIFTREGv2\\0" | u64
  header length | msgpack header | pad | 64-byte-aligned sections``, the
  header ``{"version": 2, "meta", "exported": {offset, length}, "arrays":
  {group: [{path, offset, dtype (by name), shape}, ...]}}``, offsets from
  the aligned start of the data. The reader maps the file and gives every
  array as a tensor viewing the mapping (no decode, no copy).
* **version 1: one msgpack blob** ``{"version": 1, "exported", "params",
  "pca", "consts", "meta"}``, arrays as flax's ndarray ext type.

The port's groups are ``params`` (the model's ``state_dict``, nested by
its dotted names), ``pca`` and ``consts``; a JAX artifact has ``params``
(a flax tree) and ``pca``, and a StableHLO program that the port cannot
run (``tools/torch_convert_artifact.py`` makes a port artifact of it).
"""
from __future__ import annotations

import io
import mmap
import os
import struct

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from .device import f32_precision, resolve_device, resolve_dtype
# registers the liftreg:: operators that a loaded program calls
from .ops import drr_kernel, pca_kernel, warp_kernel  # noqa: F401
from .pipeline import build_refiner, refine_tail
from .utils.msgpack_codec import (dtype_name, from_bytes, pack, read_msgpack,
                                  to_bytes, write_msgpack)

ARTIFACT_VERSION = 1
ARTIFACT_VERSION_V2 = 2
_MAGIC_V2 = b"LIFTREGv2\0"
_ALIGN = 64
#: ``meta["program"]`` of the port's artifacts; a JAX artifact has none
PROGRAM = "torch.export"
ENTRIES = ("register", "register_projections")
GROUPS = ("params", "pca", "consts")
CONVERT_TOOL = "tools/torch_convert_artifact.py"


def _walk(tree, path=()):
    """Deterministic ``(path, array)`` pairs of a nested dict (keys in
    sorted order, as the JAX writer walks them)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def _insert(root, path, value):
    node = root
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def nested(flat):
    """``{"a.b.c": t}`` -> ``{"a": {"b": {"c": t}}}``."""
    root = {}
    for key, value in flat.items():
        _insert(root, key.split("."), value)
    return root


def flat(tree):
    """The inverse of :func:`nested`."""
    return {".".join(path): value for path, value in _walk(tree)}


def _ordered(seq):
    """A msgpack list that came back as ``{"0": ..., "1": ...}``."""
    if isinstance(seq, dict):
        return [seq[k] for k in sorted(seq, key=int)]
    return list(seq)


def _replace(tmp, out_path):
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    os.replace(tmp, out_path)
    return out_path


def _write_v2(payload, out_path):
    exported = bytes(payload["exported"])
    offset = 0

    def alloc(nbytes):
        nonlocal offset
        off = (offset + _ALIGN - 1) // _ALIGN * _ALIGN
        offset = off + nbytes
        return off

    blobs = [(alloc(len(exported)), memoryview(exported))]
    arrays = {}
    for group in GROUPS:
        if group not in payload:
            continue
        descs = []
        for path, arr in _walk(payload[group]):
            raw = to_bytes(arr)
            off = alloc(raw.nbytes)
            blobs.append((off, raw))
            name = dtype_name(arr.dtype) if isinstance(arr, torch.Tensor) \
                else np.dtype(arr.dtype).name
            descs.append({"path": list(path), "offset": off, "dtype": name,
                          "shape": [int(s) for s in arr.shape]})
        arrays[group] = descs
    header = {"version": ARTIFACT_VERSION_V2, "meta": payload["meta"],
              "exported": {"offset": blobs[0][0], "length": len(exported)},
              "arrays": arrays}
    hdr = pack(header)
    prefix_len = len(_MAGIC_V2) + 8 + len(hdr)
    data_start = (prefix_len + _ALIGN - 1) // _ALIGN * _ALIGN
    tmp = f"{out_path}.tmp"
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(_MAGIC_V2)
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        pos = prefix_len
        for off, raw in blobs:
            f.write(b"\0" * (data_start + off - pos))
            f.write(raw)
            pos = data_start + off + raw.nbytes
    return _replace(tmp, out_path)


def _write_v1(payload, out_path):
    tmp = f"{out_path}.tmp"
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    body = {"version": ARTIFACT_VERSION,
            "exported": bytes(payload["exported"])}
    body.update((g, payload[g]) for g in GROUPS if g in payload)
    body["meta"] = payload["meta"]
    with open(tmp, "wb") as f:
        write_msgpack(body, f)
    return _replace(tmp, out_path)


def write_artifact(payload, out_path, artifact_format=ARTIFACT_VERSION_V2):
    """Write ``payload`` (``{"exported": bytes, "meta": dict, "params",
    "pca"[, "consts"]: nested dicts of tensors or arrays}``) in format 1 or
    2; returns ``out_path``. The file appears whole or not at all."""
    if artifact_format == ARTIFACT_VERSION_V2:
        return _write_v2(payload, out_path)
    if artifact_format == ARTIFACT_VERSION:
        return _write_v1(payload, out_path)
    raise ValueError(f"artifact_format {artifact_format} not in (1, 2)")


def _version_error(path, version):
    return ValueError(f"serving artifact '{path}' has version {version}; "
                      f"this loader supports versions {ARTIFACT_VERSION} and "
                      f"{ARTIFACT_VERSION_V2}")


def _read_v2(path):
    with open(path, "rb") as f:
        # a private, writable mapping: tensors may view it without copying
        # and without read-only warnings; nothing is written back
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    start = len(_MAGIC_V2)
    (hlen,) = struct.unpack("<Q", mm[start:start + 8])
    prefix_len = start + 8 + hlen
    header = read_msgpack(mm[start + 8:prefix_len])
    version = int(header.get("version", -1))
    if version != ARTIFACT_VERSION_V2:
        raise _version_error(path, version)
    data_start = (prefix_len + _ALIGN - 1) // _ALIGN * _ALIGN
    payload = {"version": version, "meta": header["meta"]}
    exp = header["exported"]
    off = data_start + int(exp["offset"])
    payload["exported"] = bytes(mm[off:off + int(exp["length"])])
    for group, descs in header["arrays"].items():
        tree = {}
        for d in _ordered(descs):
            arr = from_bytes(mm, d["dtype"], _ordered(d["shape"]),
                             offset=data_start + int(d["offset"]))
            _insert(tree, [str(k) for k in _ordered(d["path"])], arr)
        payload[group] = tree
    return payload


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    return tree


def read_artifact(path):
    """Read a serving artifact of either format, the port's or the JAX
    package's, into ``{"version", "exported" (bytes), "params", "pca",
    ["consts",] "meta"}`` without touching a device. Arrays are CPU
    tensors (bf16 ones too), in v2 views of a private mapping of the
    file."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC_V2))
    if magic == _MAGIC_V2:
        return _read_v2(path)
    with open(path, "rb") as f:
        payload = read_msgpack(f.read())
    version = int(payload.get("version", -1))
    if version != ARTIFACT_VERSION:
        raise _version_error(path, version)
    return {k: _tensors(v) if k in GROUPS else v for k, v in payload.items()}


def is_port_artifact(meta):
    return meta.get("program") == PROGRAM


class _Program(torch.nn.Module):
    """What is exported: the pipeline's amortized entry with its weights,
    basis and constants as inputs. The pipeline is held outside the module
    tree, so that no weight becomes a parameter of the program."""

    def __init__(self, pipe, entry):
        super().__init__()
        self.__dict__["pipe"] = pipe
        self.entry = entry

    def forward(self, params, pca, consts, *args):
        pipe = self.pipe
        predict = pipe.predict if self.entry == "register" \
            else pipe.predict_projections
        out, inputs = predict(consts, pca, *args, params=params)
        if not pipe.refine_steps:
            return out["warped"], out["phi"]
        return (out["warped"], out["phi"], out["pca_coefs"],
                pipe._moving_cp(inputs), pipe.refine_target(out, inputs))


def _groups(params, pca, consts):
    """The program's first three inputs from the artifact's groups: the
    weights as a flat ``state_dict``, the basis and the constants, each
    with its keys in sorted order (the program's input spec holds the
    order it was exported with)."""
    return (flat(params), dict(sorted(pca.items())),
            dict(sorted(consts.items())))


def _dtype_meta(dtype):
    return dtype_name(dtype) if dtype is not None else ""


def _meta(pipe, batch_size, entry):
    """The artifact's meta: the pipeline's ``settings`` (dtypes by name,
    "" for none; tuples as lists), which hold the JAX package's keys and
    every other setting that changes the result, and the batch, the entry
    and the device type the program was exported on."""
    meta = {k: _dtype_meta(v) if k.endswith("_dtype")
            else list(v) if isinstance(v, tuple) else v
            for k, v in pipe.settings.items()}
    meta.update(batch_size=int(batch_size), entry=entry,
                platforms=[pipe.device.type], program=PROGRAM,
                device=pipe.device.type, torch_version=torch.__version__)
    return meta


def _example_inputs(pipe, batch_size, entry):
    """Zero inputs of the entry's shapes at ``batch_size``, on the
    pipeline's device: (source, target, source_seg, target_seg) or
    (source, target_proj, source_seg)."""
    vol = torch.zeros((batch_size, 1) + pipe.img_sz, device=pipe.device)
    if entry == "register":
        return vol, vol.clone(), vol.clone(), vol.clone()
    proj = torch.zeros((batch_size, len(pipe.poses)) + pipe.resolution,
                       device=pipe.device)
    return vol, proj, vol.clone()


def _export_program(pipe, pca, batch_size, entry="register"):
    """The ``torch.export`` program of the pipeline's ``entry`` at
    ``batch_size`` (see the module docstring), traced on the pipeline's
    device: ``program(params, pca, consts, *inputs)``."""
    if entry not in ENTRIES:
        raise ValueError(f"entry {entry!r} not in {ENTRIES}")
    if entry == "register_projections" and pipe.refine_steps \
            and pipe.refine_domain != "projection":
        raise ValueError(
            "entry='register_projections' with refine_steps requires the "
            "pipeline to be built with refine_domain='projection' "
            "(image-domain refinement needs a target CT)")
    params = nested({k: v.detach()
                     for k, v in pipe.model.state_dict().items()})
    with torch.no_grad():
        return torch.export.export(
            _Program(pipe, entry),
            (*_groups(params, pca, pipe.constants()),
             *_example_inputs(pipe, batch_size, entry)), strict=False)


def export_serving(pipe, pca, batch_size, out_path, entry="register",
                   artifact_format=ARTIFACT_VERSION_V2):
    """Export a pipeline's entry and package it with its weights.

    ``pipe``: a built :class:`.pipeline.RegistrationPipeline` whose model
    holds the weights; ``pca``: its basis ``{"vectors", "mean"}``;
    ``batch_size``: the batch the program is specialized to; ``entry``:
    ``"register"`` (CT pair in) or ``"register_projections"`` (moving CT
    and measured projections in; pair it with ``refine_domain=
    "projection"`` to refine). ``artifact_format``: 2 (zero-copy
    sections) or 1 (one msgpack blob). Returns ``out_path``."""
    if artifact_format not in (ARTIFACT_VERSION, ARTIFACT_VERSION_V2):
        raise ValueError(f"artifact_format {artifact_format} not in (1, 2)")
    program = _export_program(pipe, pca, batch_size, entry)
    # torch.export.save would also write the example inputs: the weights
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    payload = {
        "exported": buf.getvalue(),
        "params": nested({k: v.detach() for k, v in
                          pipe.model.state_dict().items()}),
        "pca": {"vectors": pca["vectors"], "mean": pca["mean"]},
        "consts": pipe.constants(),
        "meta": _meta(pipe, batch_size, entry),
    }
    return write_artifact(payload, out_path, artifact_format)


def _on(tree, device):
    return {k: _on(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


class ServingModel:
    """Load a serving artifact and register CT pairs.

    Example::

        srv = ServingModel.load("flagship.liftreg")
        warped, phi = srv.register(source_hu, target_hu, src_seg, tgt_seg)

    Calls take (B', ...) tensors (or numpy arrays) with 1 <= B' <= the
    exported batch; a partial batch is padded by repeating its last row
    and the outputs are sliced back. Every call runs under
    :func:`.device.f32_precision`, which the exported graph does not keep:
    an f32 artifact's convolutions stay f32 whatever the caller's TF32
    flags. ``last_refine`` holds the refiner's output dict of the last
    refined call.
    """

    def __init__(self, program, params, pca, consts, meta, device):
        self._program = program.module()
        self._params, self._pca, self._consts = _groups(params, pca, consts)
        self._weights_on_device = False
        self._refiner = None
        self.last_refine = None
        self.meta = meta
        self.device = device
        self.batch_size = int(meta["batch_size"])
        self.img_sz = tuple(int(s) for s in meta["img_sz"])
        self.entry = meta.get("entry", "register")
        self.warp_taps_dtype = resolve_dtype(
            meta["warp_taps_dtype"] or None, "warp_taps_dtype")

    @classmethod
    def load(cls, path, device=None):
        """Read ``path`` and prepare its program for ``device`` (None: the
        CUDA card, which must exist; ``"cpu"``: the kernels' plain
        versions). A program exported on another device type is moved to
        this one explicitly (``torch.export.passes.move_to_device_pass``). A JAX artifact raises: its StableHLO program cannot
        run here."""
        payload = read_artifact(path)
        meta = payload["meta"]
        if not is_port_artifact(meta):
            raise ValueError(
                f"'{path}' was exported by the JAX package (a StableHLO "
                f"program for {list(meta.get('platforms', []))}), which "
                f"this loader cannot run; make a port artifact of it with "
                f"{CONVERT_TOOL}")
        device = resolve_device(device)
        program = torch.export.load(io.BytesIO(payload["exported"]))
        if torch.device(meta["device"]).type != device.type:
            program = move_to_device_pass(program, device)
        return cls(program, payload["params"], payload["pca"],
                   payload["consts"], meta, device)

    def _commit_weights(self):
        """Move the weights, the basis and the constants to the device once,
        at the first call (``load`` stays device-free for inspection), and
        build the refiner there."""
        if self._weights_on_device:
            return
        self._params = _on(self._params, self.device)
        self._pca = _on(self._pca, self.device)
        self._consts = _on(self._consts, self.device)
        m = self.meta
        if int(m["refine_steps"]):
            self._refiner = build_refiner(
                self.img_sz, self._consts["poses"],
                tuple(m["resolution"]), tuple(m["spacing"]),
                m["refine_domain"], sim=m["refine_sim"],
                sim_opts=m["refine_sim_opts"],
                n_steps=int(m["refine_steps"]), lr=m["refine_lr"],
                reg_factor=m["refine_reg_factor"],
                warp_taps_dtype=self.warp_taps_dtype,
                early_stop_patience=m["refine_early_stop_patience"],
                early_stop_tol=m["refine_early_stop_tol"])
        self._weights_on_device = True

    def _validate(self, named, b_in, vol_names):
        if not 1 <= b_in <= self.batch_size:
            raise ValueError(
                f"batch {b_in} outside [1, {self.batch_size}]: this "
                f"artifact was exported for batch_size={self.batch_size}")
        for name, arr in named:
            if arr is None:
                continue
            expect = (b_in, 1) + self.img_sz if name in vol_names else \
                (b_in, int(self.meta["n_proj"])) + \
                tuple(int(r) for r in self.meta["resolution"])
            if tuple(arr.shape) != expect:
                raise ValueError(
                    f"{name} shape {tuple(arr.shape)} != {expect} "
                    f"(artifact img_sz {self.img_sz}, batch {b_in})")

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _pad(self, x, b_in):
        pad = self.batch_size - b_in
        if pad == 0:
            return x
        return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])

    def _call(self, b_in, args):
        self._commit_weights()
        args = [self._pad(a, b_in) for a in args]
        with torch.no_grad(), f32_precision():
            outs = self._program(self._params, self._pca, self._consts,
                                 *args)
            if self._refiner is None:
                warped, phi = outs
            else:
                warped, phi, coefs, moving_cp, target = outs
                warped, phi, self.last_refine = refine_tail(
                    self._refiner, self.meta["refine_domain"],
                    self.warp_taps_dtype, coefs, self._pca, moving_cp,
                    target, args[0])
        return warped[:b_in], phi[:b_in]

    def _entry_guard(self, entry):
        if self.entry != entry:
            raise ValueError(f"this artifact was exported with entry="
                             f"{self.entry!r}; call {self.entry}() instead")

    def register(self, source_hu, target_hu, source_seg=None,
                 target_seg=None):
        """(B', 1, D, W, H) HU volumes with 1 <= B' <= batch_size; segs
        optional {0, 1} masks (default: all ones). Returns ``(warped,
        phi)``."""
        self._entry_guard("register")
        named = [(n, None if a is None else self._tensor(a)) for n, a in (
            ("source_hu", source_hu), ("target_hu", target_hu),
            ("source_seg", source_seg), ("target_seg", target_seg))]
        b_in = int(named[0][1].shape[0])
        self._validate(named, b_in, {n for n, _ in named})
        src, tgt, sseg, tseg = (a for _, a in named)
        sseg = torch.ones_like(src) if sseg is None else sseg
        tseg = torch.ones_like(tgt) if tseg is None else tseg
        return self._call(b_in, (src, tgt, sseg, tseg))

    def register_projections(self, source_hu, target_proj, source_seg=None):
        """The CT-free entry: moving CT and measured projections
        ``target_proj`` (B', P, pw, ph) in the normalized DRR convention.
        Only for artifacts exported with ``entry="register_projections"``.
        """
        self._entry_guard("register_projections")
        named = [(n, None if a is None else self._tensor(a)) for n, a in (
            ("source_hu", source_hu), ("target_proj", target_proj),
            ("source_seg", source_seg))]
        b_in = int(named[0][1].shape[0])
        self._validate(named, b_in, {"source_hu", "source_seg"})
        src, proj, sseg = (a for _, a in named)
        sseg = torch.ones_like(src) if sseg is None else sseg
        return self._call(b_in, (src, proj, sseg))
