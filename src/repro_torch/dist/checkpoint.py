"""Atomic manifest checkpointer for train states (``repro.dist.checkpoint``
in PyTorch), with the JAX package's on-disk layout:

    <dir>/step_00000040/
        manifest.json       # {"step", "leaves": [{"path", "file", "shape",
                            #   "dtype", "crc32"}, ...]}, written last
        leaf_00000.npy ...  # one file per leaf in np.save's format, in
                            # keypath order

A step directory is written through a temp dir and ``os.replace``, so a
checkpoint exists whole (manifest present) or not at all. Leaf paths are
the port's tree in JAX's keystr style (``.dense['bottom.0.w']``,
``.opt.mu['bottom.0.w']``, ``.table.rows``, ``.step``), dict keys sorted as
JAX's flatten sorts them. ``crc32`` is zlib's CRC32 of the whole leaf file.

Restore is template-driven: the caller passes a state of the expected
structure; leaf count, paths, shapes and dtypes are checked against the
manifest (``ValueError`` on any mismatch) and every leaf's CRC32 is
verified (``ValueError``; a manifest without checksums restores
unverified) before the first byte is copied, so a restore that raises
leaves the template as it was. ``restore_latest_verifiable`` walks steps
newest-first past damaged ones.

Memory: a leaf larger than one chunk (``CHUNK_BYTES``) streams between the
file and wherever it lives (card or host) through one reused staging
buffer, and a restore copies into the template's tensors in place, keeping
their device and dtype: a full-width master is never copied whole to the
host, and one master is alive on the card. Nothing is pickled.

A bfloat16 leaf is written as JAX's ``np.save`` of an ``ml_dtypes``
bfloat16 array writes it: its bits, under the header descr ``'<V2'`` (two
raw bytes), with ``"bfloat16"`` as the manifest's dtype; it reads back as
16-bit words viewed as ``torch.bfloat16``. Neither side needs
``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
_MANIFEST = "manifest.json"
# the largest piece of a leaf that is staged on the host at once
CHUNK_BYTES = 256 << 20

_NP_DTYPES = {
    torch.float64: np.float64, torch.float32: np.float32, torch.float16: np.float16,
    torch.int64: np.int64, torch.int32: np.int32, torch.int16: np.int16,
    torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_,
}
# numpy has no bfloat16: np.save of an ml_dtypes bfloat16 array writes this
# descr, and str() of its dtype is this manifest entry
BF16_DESCR, BF16_DTYPE = "<V2", "bfloat16"


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------


def flatten_state(state: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(keystr path, tensor)`` for every leaf of a tree of named tuples,
    dicts (keys sorted), lists and tensors, in JAX's flatten order."""
    if isinstance(state, torch.Tensor):
        return [(prefix, state)]
    if isinstance(state, dict):
        return [leaf for k in sorted(state)
                for leaf in flatten_state(state[k], f"{prefix}[{k!r}]")]
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return [leaf for name, v in zip(state._fields, state)
                for leaf in flatten_state(v, f"{prefix}.{name}")]
    if isinstance(state, (list, tuple)):
        return [leaf for i, v in enumerate(state)
                for leaf in flatten_state(v, f"{prefix}[{i}]")]
    if state is None:
        return []
    raise TypeError(f"{prefix or 'state'}: cannot checkpoint a {type(state).__name__}")


def _leaf_format(t: torch.Tensor, path: str) -> Tuple[str, str]:
    """``(header descr, manifest dtype)`` of a leaf, as JAX's ``np.save``
    writes them."""
    if t.dtype == torch.bfloat16:
        return BF16_DESCR, BF16_DTYPE
    try:
        dtype = np.dtype(_NP_DTYPES[t.dtype])
    except KeyError:
        raise ValueError(f"{path}: no numpy dtype for {t.dtype}") from None
    return np.lib.format.dtype_to_descr(dtype), str(dtype)


def _words(flat: torch.Tensor) -> torch.Tensor:
    """A flat tensor as numpy can take it: a bfloat16 one as its 16-bit
    words (a view), any other as it is."""
    return flat.view(torch.int16) if flat.dtype == torch.bfloat16 else flat


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{int(step):08d}")


def _add(timings: Optional[Dict[str, float]], key: str, t0: float) -> None:
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0


# ---------------------------------------------------------------------------
# leaf files
# ---------------------------------------------------------------------------


def _npy_header(shape: Tuple[int, ...], descr: str) -> bytes:
    """The header ``np.save`` writes for a C-ordered array of this shape and
    descr (format 1.0, which fits any header a train state needs)."""
    import io

    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, {
        "descr": descr, "fortran_order": False,
        "shape": tuple(int(s) for s in shape)})
    return buf.getvalue()


def _pieces(flat: torch.Tensor) -> Iterator[Tuple[int, int]]:
    step = max(CHUNK_BYTES // flat.element_size(), 1)
    for lo in range(0, flat.numel(), step):
        yield lo, min(lo + step, flat.numel())


def _staging(flat: torch.Tensor) -> torch.Tensor:
    """One chunk's host buffer for a card tensor (pinned: the copies run at
    the bus's rate); empty for a host tensor, which needs none."""
    if flat.device.type == "cpu":
        return flat.new_empty(0)
    n = min(flat.numel(), max(CHUNK_BYTES // flat.element_size(), 1))
    return torch.empty(n, dtype=flat.dtype, pin_memory=True)


def _write_leaf(fpath: str, t: torch.Tensor, descr: str,
                timings: Optional[Dict[str, float]]) -> int:
    """Write ``t`` as ``np.save`` would, chunk by chunk; returns the file's
    CRC32."""
    flat = _words(t.detach().contiguous().reshape(-1))
    stage = _staging(flat)
    header = _npy_header(tuple(t.shape), descr)
    crc = zlib.crc32(header)
    with open(fpath, "wb") as f:
        f.write(header)
        for lo, hi in _pieces(flat):
            t0 = time.perf_counter()
            if stage.numel():
                piece = stage[:hi - lo]
                piece.copy_(flat[lo:hi])  # waits for the card
            else:
                piece = flat[lo:hi]
            _add(timings, "d2h_s", t0)
            t0 = time.perf_counter()
            data = memoryview(piece.numpy()).cast("B")
            f.write(data)
            crc = zlib.crc32(data, crc)
            _add(timings, "write_s", t0)
    return crc


def _crc32_file(path: str) -> int:
    crc = 0
    buf = bytearray(max(min(CHUNK_BYTES, 64 << 20, os.path.getsize(path)), 1))
    view = memoryview(buf)
    with open(path, "rb") as f:
        while True:
            n = f.readinto(buf)
            if not n:
                return crc
            crc = zlib.crc32(view[:n], crc)


def _open_leaf(fpath: str, entry: dict):
    """Open a leaf file and read its header; the file is left at the data.
    ``ValueError`` where the header or the size disagree with the manifest."""
    f = open(fpath, "rb")
    try:
        version = np.lib.format.read_magic(f)
        read = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}.get(version)
        if read is None:
            raise ValueError(f"{entry['path']}: leaf {entry['file']} is .npy "
                             f"format {version}, not 1.0 or 2.0")
        shape, fortran, dtype = read(f)
        named = BF16_DTYPE if dtype == np.dtype("V2") else str(dtype)  # a bf16 leaf
        if fortran or dtype.hasobject or list(shape) != list(entry["shape"]) \
                or named != entry["dtype"]:
            raise ValueError(
                f"{entry['path']}: leaf {entry['file']} holds {dtype}{list(shape)}"
                f"{' (Fortran order)' if fortran else ''}, the manifest says "
                f"{entry['dtype']}{entry['shape']}")
        want = f.tell() + int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        size = os.fstat(f.fileno()).st_size
        if size != want:
            raise ValueError(f"{entry['path']}: leaf {entry['file']} has {size} "
                             f"bytes, its header needs {want}: a torn write")
        return f
    except BaseException:
        f.close()
        raise


def _load_leaf(fpath: str, entry: dict, t: torch.Tensor,
               timings: Optional[Dict[str, float]]) -> None:
    """Copy a verified leaf file into ``t`` in place, chunk by chunk."""
    dst = t.detach()
    whole = dst.reshape(-1) if dst.is_contiguous() else torch.empty(
        dst.numel(), dtype=dst.dtype, device=dst.device)
    flat = _words(whole)
    on_host = flat.device.type == "cpu"
    stage = _staging(flat)
    with _open_leaf(fpath, entry) as f:
        for lo, hi in _pieces(flat):
            t0 = time.perf_counter()
            piece = flat[lo:hi] if on_host else stage[:hi - lo]
            view = memoryview(piece.numpy()).cast("B")
            if f.readinto(view) != view.nbytes:
                raise ValueError(f"{entry['path']}: leaf {entry['file']} ended early")
            if not on_host:
                flat[lo:hi].copy_(piece)
            _add(timings, "load_s", t0)
    if whole.data_ptr() != dst.data_ptr():
        dst.copy_(whole.view(dst.shape))


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------


def save_checkpoint(ckpt_dir: str, state: Any, step: int, store: Any = None,
                    *, timings: Optional[Dict[str, float]] = None,
                    injector: Any = None) -> str:
    """Write ``state`` at ``step`` atomically; returns the checkpoint path.
    An existing checkpoint for the same step is replaced.

    While a run is in flight the master lives in an embedding store and the
    state carries a zero-row placeholder: the DBP driver exports the master
    (``store.export_table()``) before it calls its checkpoint callback, and
    ``store=`` does the same here. Saving the placeholder itself raises.
    The layout is the same on every tier, so a checkpoint of one tier
    restores into another; the cache's contents and policy state stay out
    of it (a restore starts cold, which changes no value).

    ``timings``, when given, gains the seconds spent copying chunks off the
    card (``d2h_s``) and writing and checksumming them (``write_s``).

    ``injector`` (a ``dist.inject.FaultInjector``) is the chaos seam: after
    the atomic replace, its ``ckpt_torn`` site truncates the largest leaf
    to half and ``ckpt_corrupt`` flips 8 bytes at its middle, the damage a
    killed write or bit rot leaves, which a restore's CRC32 check finds."""
    table = getattr(state, "table", None)
    rows = getattr(table, "rows", None)
    if rows is not None and rows.shape[0] == 0:
        if store is not None and getattr(store, "owns_master", False):
            state = state._replace(table=store.export_table())
        elif store is not None:
            raise ValueError(
                "state.table is a zero-row store placeholder but the given "
                "store does not own a master (owns_master=False: already "
                "released?); there is nothing to export")
        else:
            raise ValueError(
                "state.table is a zero-row store placeholder: the master "
                "lives in an embedding store; pass store= (or save "
                "state._replace(table=store.export_table()); the DBP "
                "driver's checkpoint callback already does this)")
    leaves = flatten_state(state)
    formats = [_leaf_format(x, path) for path, x in leaves]  # refuse before writing
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = tempfile.mkdtemp(prefix=".tmp_save_", dir=ckpt_dir)
    try:
        index = []
        for i, ((path, leaf), (descr, dtype)) in enumerate(zip(leaves, formats)):
            fname = f"leaf_{i:05d}.npy"
            crc = _write_leaf(os.path.join(tmp, fname), leaf, descr, timings)
            index.append({"path": path, "file": fname, "shape": list(leaf.shape),
                          "dtype": dtype, "crc32": crc})
        t0 = time.perf_counter()
        # manifest last: its presence marks the payload as complete
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump({"step": int(step), "leaves": index}, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _add(timings, "write_s", t0)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if injector is not None:
        _maybe_corrupt(final, index, injector)
    return final


def _maybe_corrupt(final: str, index: List[dict], injector: Any) -> None:
    """Damage a just-written checkpoint where the injector's schedule says
    so (:func:`save_checkpoint`): the largest leaf, so the damage hits real
    payload and not a scalar's header."""
    victim = max(index, key=lambda e: os.path.getsize(os.path.join(final, e["file"])))
    path = os.path.join(final, victim["file"])
    if injector.should("ckpt_torn"):
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    if injector.should("ckpt_corrupt"):
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(size // 2)
            raw = f.read(8)
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in raw))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Highest step with a COMPLETE checkpoint (manifest present), else None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, _MANIFEST)):
            s = int(m.group(1))
            best = s if best is None else max(best, s)
    return best


def read_manifest(ckpt_dir: str, step: Optional[int] = None) -> Tuple[str, dict]:
    """``(step directory, manifest)`` of ``step`` (default: the latest
    complete one); ``FileNotFoundError`` when there is none."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, _MANIFEST)) as f:
        return d, json.load(f)


def verify_leaf(d: str, entry: dict) -> str:
    """Check a leaf file's CRC32 against its manifest entry (skipped where
    the manifest carries none) and its header against the entry; returns
    its path."""
    fpath = os.path.join(d, entry["file"])
    if "crc32" in entry:
        got = _crc32_file(fpath)
        if got != entry["crc32"]:
            raise ValueError(
                f"{entry['path']}: checkpoint leaf {entry['file']} failed CRC32 "
                f"(manifest {entry['crc32']}, payload {got}): torn write or bit "
                "rot; try restore_latest_verifiable")
    _open_leaf(fpath, entry).close()
    return fpath


def restore_checkpoint(ckpt_dir: str, state: Any, step: Optional[int] = None,
                       *, timings: Optional[Dict[str, float]] = None) -> Any:
    """Load the checkpoint at ``step`` (default: the latest) into the
    template ``state``: each leaf is copied into the template's tensor in
    place (its device and dtype kept), and a new tree of the template's
    structure over those tensors is returned. ``FileNotFoundError`` when no
    complete checkpoint exists; ``ValueError`` on any structure, shape,
    dtype or CRC32 mismatch, raised before any tensor is written.

    ``timings``, when given, gains the seconds of the checksum pass
    (``verify_s``) and of the copies into the tensors (``load_s``)."""
    d, manifest = read_manifest(ckpt_dir, step)
    template = flatten_state(state)
    index = manifest["leaves"]
    if len(index) != len(template):
        raise ValueError(
            f"checkpoint has {len(index)} leaves, template has {len(template)}")
    for entry, (path, leaf) in zip(index, template):
        if entry["path"] != path:
            raise ValueError(f"leaf path mismatch: checkpoint {entry['path']!r} "
                             f"vs template {path!r}")
        if tuple(entry["shape"]) != tuple(leaf.shape):
            raise ValueError(f"{path}: checkpoint shape {tuple(entry['shape'])} != "
                             f"template shape {tuple(leaf.shape)}")
        want = _leaf_format(leaf, path)[1]
        if entry["dtype"] != want:
            raise ValueError(f"{path}: checkpoint dtype {entry['dtype']} != "
                             f"template dtype {want}")
    t0 = time.perf_counter()
    files = [verify_leaf(d, entry) for entry in index]
    _add(timings, "verify_s", t0)
    for fpath, entry, (_, leaf) in zip(files, index, template):
        _load_leaf(fpath, entry, leaf, timings)
    return _rebuild(state)


def _rebuild(tree: Any) -> Any:
    """The tree's structure anew over the same tensors: a holder of the old
    dicts (a module built from ``state.dense``) sees the state changed."""
    if isinstance(tree, dict):
        return {k: _rebuild(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v) for v in tree)
    return tree


def restore_latest_verifiable(ckpt_dir: str, state: Any,
                              *, timings: Optional[Dict[str, float]] = None
                              ) -> Tuple[Any, int]:
    """Restore the NEWEST checkpoint that passes full verification
    (manifest structure and per-leaf CRC32), walking steps descending past
    damaged ones; returns ``(state, step)``. ``FileNotFoundError`` when none
    under ``ckpt_dir`` restores clean. A failed attempt writes nothing into
    the template, and falling back a step is safe: the trajectory is
    deterministic, so resuming earlier replays the same steps."""
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoint directory {ckpt_dir}")
    steps = sorted((int(m.group(1)) for m in
                    (_STEP_RE.match(n) for n in os.listdir(ckpt_dir)) if m),
                   reverse=True)
    errors = []
    for step in steps:
        try:
            return restore_checkpoint(ckpt_dir, state, step, timings=timings), step
        except (ValueError, OSError, KeyError, json.JSONDecodeError) as e:
            errors.append(f"step {step}: {e}")
    raise FileNotFoundError(
        f"no verifiable checkpoint under {ckpt_dir}"
        + ("; tried: " + "; ".join(errors) if errors else ""))


__all__ = ["CHUNK_BYTES", "flatten_state", "latest_step",
           "read_manifest", "restore_checkpoint", "restore_latest_verifiable",
           "save_checkpoint", "verify_leaf"]
