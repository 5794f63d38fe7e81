"""Full-state checkpointing: async, atomic, sharded, durable
(port of ``repro/checkpoint/checkpoint.py``, the same on-disk format).

A checkpoint carries the parameters, the AdamW state (its step counter
too), the error-feedback residual, the capacity plan (a structured record
that loads back into a ``CapacityPlan``) and the data-stream position
(epoch and batches consumed within it), so a restart on a different
number of ranks resumes the same global sample stream.

On-disk layout (version 3): ``<dir>/step_<N>/``

  arrays_host<k>.npz
               host ``k``'s shards of the state, keyed by the escaped
               ``/``-joined leaf path (``repack.flatten_with_paths``).
               Packed 2-D stacks (``packed_fields``) are split by bucket
               rows along the layout record's host extents, the (ranks,
               ...) ``err`` stack by rank; every other leaf is written
               whole by one host, balanced by bytes. The host count is
               ``meta["format"]["hosts"]`` (the pod count).
  manifest.json
               per-file byte sizes and sha256 checksums and the key ->
               shard-extent map each file holds. Restore refuses a step
               on any mismatch and falls back to the previous committed
               one.
  meta.json    step, epoch, seed, the plan, the data-stream position and
               the ``"format"`` block (format version, packed fields,
               layout record, writing overlap mode, host count).
  _DONE        commit marker, written into the temporary directory
               before the atomic rename: a crash at any point leaves
               either a committed ``step_<N>`` or an ignorable ``.tmp``.

Every file is fsynced after it is written, the temporary directory
before the rename and the parent directory after it. Version 2 (one
``arrays.npz``, no manifest, as the JAX package's
``save(format_version=2)`` writes it) still loads.

Restore reassembles the shards into the flat ``{key: array}`` dict,
passes it through ``repack.adapt_arrays`` (any packed grid, pytree
moments, flat or per-leaf residual, any rank count) and unflattens it
into the caller's template. A dtype cast that would lose precision is
refused.

Async: ``save`` takes the state as host numpy arrays the caller does not
touch again (``launch/steps.py::state_to_host`` makes fresh copies),
and writes them on a background thread; a write that fails after its
retries raises from the next ``wait()``. Call ``wait()`` on every exit
path, or the last checkpoint of a run is lost with the thread.

Unlike the JAX package, which serialises each shard file to memory and
hashes those bytes, this writer has ``np.savez`` write each ``.npz`` to
its file and hashes the file as written: the same files and manifest,
with no second in-memory copy of a 14 GB state. The reader takes each
stored member straight from its offset, a large one mapped rather than
read, so a pipeline stage's restore brings into memory only the pages
of its own part. Format code is numpy and the standard library only.
"""
from __future__ import annotations

import glob
import hashlib
import json
import logging
import os
import shutil
import struct
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import repack
from repro_torch.core.capacity import (CapacityPlan, host_shard_extents,
                                       plan_from_record, plan_record)

_DONE = "_DONE"
_PLAN_TAG = "__capacity_plan__"
_MANIFEST = "manifest.json"
_META = "meta.json"
_IO_RETRIES = 3                 # write attempts per save
_MAP_BYTES = 1 << 20            # a stored member this large is mapped

logger = logging.getLogger(__name__)


class CheckpointCorruptError(RuntimeError):
    """A committed step failed manifest/content validation (truncated or
    bit-flipped shard, missing manifest, unreadable file). ``restore``
    falls back to the previous committed step unless the caller asked
    for this step explicitly."""


def _float_envelope(dt: np.dtype) -> Optional[Tuple[int, int, int]]:
    """(mantissa bits, max exponent, min exponent) of a float dtype;
    bfloat16 by name, since numpy has no such type."""
    if dt.kind == "f":
        fi = np.finfo(dt)
        return fi.nmant, fi.maxexp, fi.minexp
    if dt.name == "bfloat16":
        return 7, 128, -126
    return None


def _cast_is_lossy(src: np.dtype, dst: np.dtype) -> bool:
    """Whether restoring a ``src`` leaf into a ``dst`` template leaf
    loses information (fp32 -> bf16, float -> int, int64 -> int32).
    Float pairs compare precision envelopes; anything undecidable counts
    as lossy."""
    if src == dst:
        return False
    fs, fd = _float_envelope(src), _float_envelope(dst)
    if fs is not None and fd is not None:
        return not (fd[0] >= fs[0] and fd[1] >= fs[1] and fd[2] <= fs[2])
    try:
        return not np.can_cast(src, dst, casting="safe")
    except TypeError:
        return True


def _unflatten_like(template: Any, arrays: Dict[str, np.ndarray]) -> Any:
    leaves: Dict[str, np.ndarray] = {}
    cast = []
    for key, leaf in repack.flatten_with_paths(template).items():
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf '{key}'")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for '{key}': ckpt {arr.shape} vs "
                f"model {tuple(leaf.shape)}")
        src, dst = np.dtype(arr.dtype), np.dtype(leaf.dtype)
        if src != dst:
            if _cast_is_lossy(src, dst):
                raise ValueError(
                    f"lossy dtype cast for '{key}': checkpoint {src} "
                    f"-> template {dst} would lose precision")
            cast.append((key, src, dst))
        leaves[key] = arr.astype(dst, copy=False)
    if cast:
        logger.warning(
            "checkpoint restore cast %d leaf/leaves to the template "
            "dtype (first: '%s' %s -> %s)", len(cast), cast[0][0],
            cast[0][1], cast[0][2])
    return repack.unflatten_like(template, leaves)


def _json_default(obj: Any) -> Any:
    """Structured meta serialization, never a silent ``str()``: a plan
    becomes a tagged record that ``_meta_hook`` rebuilds; numpy values
    become JSON numbers and lists; anything else raises."""
    if isinstance(obj, CapacityPlan):
        return {_PLAN_TAG: plan_record(obj)}
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    raise TypeError(
        f"checkpoint meta value of type {type(obj).__name__!r} is not "
        f"JSON-serializable — give it a structured record (see "
        f"plan_record) instead of relying on str()")


def _meta_hook(d: Dict) -> Any:
    if set(d) == {_PLAN_TAG}:
        return plan_from_record(d[_PLAN_TAG])
    return d


# ---- durability primitives ------------------------------------------------


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_json_synced(path: str, obj: Any) -> None:
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)
        fh.flush()
        os.fsync(fh.fileno())


def _write_bytes_synced(path: str, data: bytes) -> Dict[str, Any]:
    with open(path, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    return {"bytes": len(data),
            "sha256": hashlib.sha256(data).hexdigest()}


def _read_npz(path: str) -> Dict[str, np.ndarray]:
    """Every array of an ``np.savez`` file, as ``np.load`` gives them.
    A stored (uncompressed) member, as ``np.savez`` writes, is taken
    straight from its offset in the file: ``np.load`` would stream it
    through zipfile's CRC check, at a third of the speed, and the
    manifest's sha256 has covered these bytes already. One of
    ``_MAP_BYTES`` or more is mapped copy-on-write (``np.memmap`` mode
    "c"), so a caller that uses part of it (a pipeline stage's layers of
    a stacked leaf) reads only those pages; a smaller one is read into
    memory. Other members go through ``np.lib.format.read_array``."""
    out: Dict[str, np.ndarray] = {}
    fmt = np.lib.format
    with zipfile.ZipFile(path) as zf, open(path, "rb") as fh:
        for info in zf.infolist():
            key = info.filename.removesuffix(".npy")
            fh.seek(info.header_offset)
            head = fh.read(30)                 # the local file header
            if info.compress_type != zipfile.ZIP_STORED or \
                    head[:4] != b"PK\x03\x04":
                with zf.open(info) as member:
                    out[key] = fmt.read_array(member)
                continue
            name_len, extra_len = struct.unpack("<HH", head[26:30])
            fh.seek(info.header_offset + 30 + name_len + extra_len)
            major, _ = fmt.read_magic(fh)
            if major not in (1, 2):
                raise ValueError(f"npy format version {major} in {path}")
            read_header = (fmt.read_array_header_1_0 if major == 1
                           else fmt.read_array_header_2_0)
            shape, fortran, dtype = read_header(fh)
            count = int(np.prod(shape))
            order = "F" if fortran else "C"
            if count * dtype.itemsize >= _MAP_BYTES:
                # a file too short to hold it raises ValueError here
                out[key] = np.memmap(path, dtype=dtype, mode="c",
                                     offset=fh.tell(), shape=shape,
                                     order=order)
                continue
            arr = np.fromfile(fh, dtype=dtype, count=count)
            if arr.size != count:
                raise zipfile.BadZipFile(f"'{key}' in {path} is truncated")
            out[key] = arr.reshape(shape, order=order)
    return out


def _shard_across_hosts(flat: Dict[str, np.ndarray], fmt: Dict,
                        num_hosts: int
                        ) -> Tuple[List[Dict[str, np.ndarray]],
                                   List[Dict[str, Dict]]]:
    """Partition the flat array dict over ``num_hosts`` writer files:
    packed stacks by bucket rows, the err stack by rank (along the
    layout record's extents when they match, else a balanced split),
    every other leaf whole on the least-loaded host. Returns per-host
    ``{key: shard}`` dicts and the manifest's key records."""
    packed = set(fmt.get("packed_fields") or ())
    layout = fmt.get("layout") or {}
    host_arrays: List[Dict[str, np.ndarray]] = [
        {} for _ in range(num_hosts)]
    key_records: List[Dict[str, Dict]] = [{} for _ in range(num_hosts)]
    loads = [0] * num_hosts
    for key, arr in flat.items():
        row_split = (num_hosts > 1 and arr.ndim >= 2
                     and (key in packed or key == repack.ERR_GROUP))
        if row_split:
            rec_ext = layout.get("host_extents")
            extents = (
                [(int(lo), int(hi)) for lo, hi in rec_ext]
                if key in packed and rec_ext is not None
                and len(rec_ext) == num_hosts
                and rec_ext[-1][1] == arr.shape[0]
                else host_shard_extents(arr.shape[0], num_hosts))
            for h, (lo, hi) in enumerate(extents):
                if hi <= lo:
                    continue
                host_arrays[h][key] = arr[lo:hi]
                key_records[h][key] = {"shape": list(arr.shape),
                                       "rows": [lo, hi]}
                loads[h] += arr[lo:hi].nbytes
        else:
            h = min(range(num_hosts), key=lambda i: loads[i])
            host_arrays[h][key] = arr
            key_records[h][key] = {"shape": list(arr.shape)}
            loads[h] += arr.nbytes
    return host_arrays, key_records


def _assemble_shards(npz_arrays: Dict[str, Dict[str, np.ndarray]],
                     manifest: Dict) -> Dict[str, np.ndarray]:
    """Per-host shard dicts -> the full flat ``{key: array}`` dict;
    split keys must cover ``[0, shape[0])`` contiguously."""
    arrays: Dict[str, np.ndarray] = {}
    shards: Dict[str, List[Tuple[int, int, np.ndarray, Tuple[int, ...]]]]
    shards = {}
    for fname, rec in manifest["files"].items():
        if fname not in npz_arrays:
            continue
        loaded = npz_arrays[fname]
        for key, krec in rec.get("keys", {}).items():
            arr = loaded[key]
            shape = tuple(int(d) for d in krec["shape"])
            if "rows" in krec:
                lo, hi = (int(x) for x in krec["rows"])
                shards.setdefault(key, []).append((lo, hi, arr, shape))
            else:
                if tuple(arr.shape) != shape:
                    raise CheckpointCorruptError(
                        f"'{key}' in {fname} has shape {arr.shape}, "
                        f"manifest records {shape}")
                arrays[key] = arr
    for key, parts in shards.items():
        parts.sort(key=lambda t: t[0])
        full = parts[0][3]
        expect = 0
        for lo, hi, arr, shape in parts:
            if shape != full or lo != expect or arr.shape[0] != hi - lo:
                raise CheckpointCorruptError(
                    f"shard coverage broken for '{key}': extent "
                    f"[{lo}, {hi}) after row {expect} of {full}")
            expect = hi
        if expect != full[0]:
            raise CheckpointCorruptError(
                f"shards of '{key}' cover {expect} rows, manifest "
                f"records {full[0]}")
        arrays[key] = np.concatenate([p[2] for p in parts], axis=0)
    return arrays


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 io_backoff_s: float = 0.05, fault_hook=None):
        """``_IO_RETRIES`` write attempts per save for a transient
        ``OSError``, with a doubling backoff from ``io_backoff_s``; each
        attempt rebuilds the ``.tmp`` directory, so a step is committed
        whole or not at all. ``fault_hook(step, tmp_path)``: called at
        the start of every attempt (the chaos engine's
        ``ckpt_io_fail`` raises there).

        Timings (seconds): ``last_save``, the latest ``save``'s wait for
        the previous write and its flatten; ``writes``, one record a
        committed write (bytes, serialise-and-fsync, sha256, attempts);
        ``last_restore``, the latest restore's manifest check, loading
        and repack."""
        self.directory = directory
        self.keep = keep
        self.io_backoff_s = float(io_backoff_s)
        self.fault_hook = fault_hook
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: List[BaseException] = []
        self._warned_names: set = set()
        self.last_save: Dict[str, Any] = {}
        self.writes: List[Dict[str, Any]] = []
        self.last_restore: Dict[str, Any] = {}

    # ---- save ------------------------------------------------------------

    def save(self, step: int, state: Any,
             meta: Optional[Dict] = None) -> None:
        """Write ``state`` (a tree of numpy arrays) as step ``step`` in
        the background (one writer at a time), in format version 3:
        ``meta["format"]["hosts"]`` shard files and a manifest."""
        t0 = time.perf_counter()
        self.wait()                       # at most one in-flight write
        t1 = time.perf_counter()
        flat = {k: np.asarray(v) for k, v in
                repack.flatten_with_paths(state).items()}  # collisions raise
        meta = dict(meta or {})
        meta["step"] = int(step)
        fmt = dict(meta.get("format") or {})
        fmt["version"] = repack.FORMAT_VERSION
        meta["format"] = fmt
        num_hosts = max(int(fmt.get("hosts") or 1), 1)
        self.last_save = {"step": int(step), "wait_s": t1 - t0,
                          "flatten_s": time.perf_counter() - t1}

        def write():
            delay = self.io_backoff_s
            for attempt in range(1, _IO_RETRIES + 1):
                try:
                    stats = self._write(step, flat, meta, num_hosts)
                    self._rotate()
                    self.writes.append({"step": int(step),
                                        "attempts": attempt, **stats})
                    return
                except OSError as e:      # transient IO: bounded retry
                    if attempt >= _IO_RETRIES:
                        self._error.append(e)
                        return
                    logger.warning(
                        "checkpoint write for step %d failed (%s) — "
                        "attempt %d/%d, retrying in %.0f ms", step, e,
                        attempt, _IO_RETRIES, delay * 1e3)
                    time.sleep(delay)
                    delay *= 2.0
                except BaseException as e:  # surfaced on next wait()
                    self._error.append(e)
                    return

        self._thread = threading.Thread(target=write, daemon=True,
                                        name=f"ckpt-write-{step}")
        self._thread.start()

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               meta: Dict, num_hosts: int) -> Dict[str, Any]:
        t_start = time.perf_counter()
        hash_s = 0.0
        final = os.path.join(self.directory, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        if self.fault_hook is not None:
            self.fault_hook(step, tmp)
        total = 0
        host_arrays, key_records = _shard_across_hosts(
            flat, meta.get("format") or {}, num_hosts)
        files: Dict[str, Dict] = {}
        for h, arrays in enumerate(host_arrays):
            fname = f"arrays_host{h}.npz"
            path = os.path.join(tmp, fname)
            np.savez(path, **arrays)
            _fsync_path(path)
            t_hash = time.perf_counter()
            files[fname] = {"bytes": os.path.getsize(path),
                            "sha256": _sha256(path),
                            "keys": key_records[h]}
            hash_s += time.perf_counter() - t_hash
            total += files[fname]["bytes"]
        meta_bytes = json.dumps(meta, indent=1,
                                default=_json_default).encode()
        files[_META] = _write_bytes_synced(os.path.join(tmp, _META),
                                           meta_bytes)
        _write_json_synced(
            os.path.join(tmp, _MANIFEST),
            {"manifest_version": 1, "format_version": repack.FORMAT_VERSION,
             "step": int(step), "hosts": num_hosts, "files": files})
        with open(os.path.join(tmp, _DONE), "w") as fh:
            fh.write("ok")
            fh.flush()
            os.fsync(fh.fileno())
        _fsync_path(tmp)                  # directory entries durable
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)             # atomic commit
        _fsync_path(self.directory)       # ... and the rename itself
        wall = time.perf_counter() - t_start
        return {"bytes": total, "seconds": wall, "sha256_s": hash_s,
                "write_s": wall - hash_s}

    def busy(self) -> bool:
        """Whether a write is in flight."""
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error.pop()

    def _rotate(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---- load ------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            try:
                s = int(name[5:])
            except ValueError:
                if name not in self._warned_names:
                    self._warned_names.add(name)
                    logger.warning(
                        "ignoring non-checkpoint entry %r in %s (does "
                        "not parse as step_<N>)", name, self.directory)
                continue
            path = os.path.join(self.directory, name)
            if os.path.exists(os.path.join(path, _DONE)):
                out.append(s)
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _validate_manifest(self, path: str) -> Dict:
        """Load + verify manifest.json: files exist, sizes and sha256
        checksums match. Raises :class:`CheckpointCorruptError`."""
        man_path = os.path.join(path, _MANIFEST)
        if not os.path.exists(man_path):
            raise CheckpointCorruptError(
                f"{path} holds per-host shard files but no {_MANIFEST}")
        try:
            with open(man_path) as fh:
                manifest = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(
                f"unreadable {_MANIFEST} in {path}: {e}") from e
        for fname, rec in manifest.get("files", {}).items():
            fpath = os.path.join(path, fname)
            if not os.path.exists(fpath):
                raise CheckpointCorruptError(
                    f"manifest names missing file '{fname}' in {path}")
            size = os.path.getsize(fpath)
            if size != int(rec["bytes"]):
                raise CheckpointCorruptError(
                    f"'{fname}' is {size} bytes, manifest records "
                    f"{rec['bytes']} (truncated?)")
            digest = _sha256(fpath)
            if digest != rec["sha256"]:
                raise CheckpointCorruptError(
                    f"content checksum mismatch for '{fname}': "
                    f"{digest[:12]}... != recorded "
                    f"{rec['sha256'][:12]}...")
        return manifest

    def verify(self, step: int) -> Dict:
        """Check step ``step``'s manifest (sizes and sha256 of every
        file); returns the manifest or raises
        :class:`CheckpointCorruptError`."""
        return self._validate_manifest(
            os.path.join(self.directory, f"step_{step:010d}"))

    def _load_step(self, step: int) -> Tuple[Dict[str, np.ndarray], Dict]:
        """Read one committed step into (flat arrays, meta); raises
        FileNotFoundError when the step was never committed and
        :class:`CheckpointCorruptError` when its content fails
        validation."""
        path = os.path.join(self.directory, f"step_{step:010d}")
        if not os.path.exists(os.path.join(path, _DONE)):
            raise FileNotFoundError(f"checkpoint {path} incomplete")
        host_files = sorted(glob.glob(
            os.path.join(path, "arrays_host*.npz")))
        v3 = host_files or os.path.exists(os.path.join(path, _MANIFEST))
        t0 = time.perf_counter()
        verify_s = 0.0
        try:
            if v3:
                manifest = self._validate_manifest(path)
                verify_s = time.perf_counter() - t0
                npz_arrays: Dict[str, Dict[str, np.ndarray]] = {}
                for fname, rec in manifest["files"].items():
                    if not fname.endswith(".npz"):
                        continue
                    loaded = _read_npz(os.path.join(path, fname))
                    if set(loaded) != set(rec.get("keys", {})):
                        raise CheckpointCorruptError(
                            f"'{fname}' holds keys "
                            f"{sorted(loaded)}, manifest records "
                            f"{sorted(rec.get('keys', {}))}")
                    npz_arrays[fname] = loaded
                arrays = _assemble_shards(npz_arrays, manifest)
            else:
                arrays_path = os.path.join(path, "arrays.npz")
                if not os.path.exists(arrays_path):
                    raise CheckpointCorruptError(
                        f"{path} holds neither arrays.npz nor per-host "
                        f"shard files")
                with np.load(arrays_path) as z:
                    arrays = {k: z[k] for k in z.files}
            with open(os.path.join(path, _META)) as fh:
                meta = json.load(fh, object_hook=_meta_hook)
        except (OSError, zipfile.BadZipFile, json.JSONDecodeError,
                KeyError, ValueError) as e:
            raise CheckpointCorruptError(
                f"unreadable checkpoint {path}: {e!r}") from e
        self.last_restore = {"step": int(step), "verify_s": verify_s,
                             "load_s": time.perf_counter() - t0 - verify_s}
        return arrays, meta

    def restore(self, template: Any, step: Optional[int] = None,
                expected_overlap: Optional[str] = None) -> Tuple[Any, Dict]:
        """Returns (state shaped like ``template``, meta), the state's
        leaves as numpy arrays. Template leaves need ``.shape`` and
        ``.dtype`` only (``repack.ShapeDtype``). With ``step=None`` a
        step that fails validation is skipped (logged) for the previous
        committed one; an explicit ``step`` raises
        :class:`CheckpointCorruptError`. ``expected_overlap``: the
        restoring config's overlap mode; a checkpoint written under
        another one still restores (through the repack) and is
        logged."""
        explicit = step is not None
        candidates = ([step] if explicit
                      else list(reversed(self.all_steps())))
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        last_err: Optional[BaseException] = None
        arrays = meta = None
        chosen = None
        for s in candidates:
            try:
                arrays, meta = self._load_step(s)
                chosen = s
                break
            except CheckpointCorruptError as e:
                if explicit:
                    raise
                logger.warning(
                    "checkpoint step_%010d failed validation (%s) — "
                    "falling back to the previous committed step", s, e)
                last_err = e
        if chosen is None:
            raise CheckpointCorruptError(
                f"no restorable checkpoint in {self.directory}: every "
                f"committed step failed validation") from last_err
        fmt = meta.get("format") or {}
        saved_overlap = fmt.get("overlap")
        if expected_overlap is not None and saved_overlap is not None \
                and saved_overlap != expected_overlap:
            logger.warning(
                "checkpoint step_%010d was written under HetConfig."
                "overlap='%s' but is being restored into overlap='%s' "
                "— optimizer state will be repacked through the flat "
                "stream (bit-exact; see checkpoint/repack.py)",
                chosen, saved_overlap, expected_overlap)
        t0 = time.perf_counter()
        arrays = repack.adapt_arrays(arrays, template, meta.get("format"))
        state = _unflatten_like(template, arrays)
        self.last_restore["adapt_s"] = time.perf_counter() - t0
        return state, meta
